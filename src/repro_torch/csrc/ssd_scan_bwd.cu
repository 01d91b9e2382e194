// Chunked Mamba2 SSD scan, backward (K7), for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
// `_ssd_bwd_kernel` behind `ssd_scan_bwd`. Inputs as K6 (x, B, C in one
// dtype, f32 or bf16; dt, A f32), plus each chunk's entering state
// s_enter [B,NC,H,P,N] f32 from K6, and the cotangents dy [B,L,H,P] f32 and
// ds_final [B,H,P,N] f32. Outputs dx [B,L,H,P] (x's dtype), ddt [B,L,H] f32,
// per-(batch, chunk, head) dA partials [B,NC,H] f32 (the wrapper sums them,
// as the reference does), and dB, dC [B,L,N] (B's dtype).
//
// Per chunk, walking the chunks in REVERSE and carrying the state cotangent
// M = dS [P,N] f32 (seeded from ds_final), the chunk's forward quantities are
// recomputed from its inputs and its entering state S, with
// W = (C.B^T) o G o dt, dW = dy . x^T and dcb = dW o G o dt:
//   dx  = W^T . dy + (exp(ct - cum) dt) o (B . M^T)
//   dC  = dcb . B + exp(cum) o (dy . S)
//   dB  = dcb^T . C + (exp(ct - cum) dt) o (x . M)
//   ddt, dA from the cotangent of cum (row and column sums of
//         gg = dW o CB o dt o G, the y-inter and state-output paths, and the
//         fold of dct into the last row), reverse-cumsummed
//   M  <- exp(ct) M + (dy o exp(cum))^T . C
// exactly as the reference's lines 164-221. As in K6, L need not be a
// multiple of q: a short last chunk's missing rows load as zeros (dy too),
// which adds nothing to any sum, and their outputs are not written; the fold
// of dct into row q - 1 reaches every valid row through the reverse cumsum,
// since the padded rows between carry d cum = 0.
//
// What bounds it on the H100, at the training shape (B36 L256 H80 P64
// N128, bf16): it reads x, B, C, dt, s_enter, dy, ds_final once and writes
// dx, ddt, dA, dB, dC (~670 MB), ~0.20 ms at 3.35 TB/s; the f32 per-head
// dB / dC partials below add ~1.5 GB of traffic, and its ~91 GFLOP of f32
// FMAs (more: it computes dW and C.B^T twice) make it compute-bound.
//
// Design. One CTA of 256 threads per (head, batch row) walks the chunks in
// reverse; M lives in shared memory across chunks, S is read from global
// memory (L2). The [q,q] matrices do not fit shared memory beside the tiles,
// so they are built in blocks of RB = 32: a row pass (rows i, all j <= i)
// that completes dC and the row sums of gg, and a column pass (columns j,
// all i >= j) that rebuilds dW and CB for its columns and completes dx, dB
// and the column sums. Each of dW and CB is therefore computed twice; that
// buys a kernel with no [q,q] tile in device memory. The TPU summed dB and
// dC over heads by revisiting one output block on consecutive grid steps;
// CUDA CTAs of different heads run in parallel, so this kernel writes
// per-head f32 partials [B,L,H,N] and a second kernel sums them over the
// heads in a fixed order and casts them. No atomics: two runs agree bit for
// bit. Row strides in shared memory carry one extra 16-byte unit, as in K6.

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA
constexpr int RB = 32;   // rows (row pass) or columns (column pass) a block

struct BwdLayout {
  int xs, bs, ds, fs, ws, nred;  // row strides (elements); red length
  size_t off_m, off_b1, off_b2, off_part, off_red, off_vec, off_dy, off_x,
      off_b, off_c, bytes;
};

template <typename T>
__host__ __device__ BwdLayout bwd_layout(int q, int P, int N) {
  BwdLayout L;
  L.xs = P + 16 / (int)sizeof(T);
  L.bs = N + 16 / (int)sizeof(T);
  L.ds = P + 4;
  L.fs = N + 4;
  L.ws = q + 4;
  L.nred = RB * (N / 8) > NT ? RB * (N / 8) : NT;
  size_t o = 0;
  L.off_m = o;    o += (size_t)P * L.fs * 4;
  L.off_b1 = o;   o += (size_t)RB * L.ws * 4;
  L.off_b2 = o;   o += (size_t)RB * L.ws * 4;
  L.off_part = o; o += (size_t)(q / 2) * RB * 4;
  L.off_red = o;  o += (size_t)((L.nred + 3) / 4 * 4) * 4;
  L.off_vec = o;  o += (size_t)8 * q * 4;
  L.off_dy = o;   o += (size_t)q * L.ds * 4;
  L.off_x = o;    o += (size_t)q * L.xs * sizeof(T);
  L.off_b = o;    o += (size_t)q * L.bs * sizeof(T);
  L.off_c = o;    o += (size_t)q * L.bs * sizeof(T);
  L.bytes = o;
  return L;
}

using repro::from_f;
using repro::load8;
using repro::to_f;

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ s_enter,
               const float* __restrict__ dy_g,
               const float* __restrict__ ds_final, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ da_part,
               float* __restrict__ db_part, float* __restrict__ dc_part,
               int Lseq, int H, int P, int N, int q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout Lo = bwd_layout<T>(q, P, N);
  float* M = reinterpret_cast<float*>(smem + Lo.off_m);
  float* b1 = reinterpret_cast<float*>(smem + Lo.off_b1);
  float* b2 = reinterpret_cast<float*>(smem + Lo.off_b2);
  float* part = reinterpret_cast<float*>(smem + Lo.off_part);
  float* red = reinterpret_cast<float*>(smem + Lo.off_red);
  float* cum = reinterpret_cast<float*>(smem + Lo.off_vec);
  float* dtv = cum + q;
  float* ev = dtv + q;       // exp(cum)
  float* dout = ev + q;      // exp(ct - cum)
  float* dcum = dout + q;    // row-pass part of d cum
  float* ddt_a = dcum + q;   // column sums + di * dout
  float* colgg = ddt_a + q;  // column sums of gg
  float* di = colgg + q;     // d(decay_in) . B
  float* DY = reinterpret_cast<float*>(smem + Lo.off_dy);
  T* Xs = reinterpret_cast<T*>(smem + Lo.off_x);
  T* Bs = reinterpret_cast<T*>(smem + Lo.off_b);
  T* Cs = reinterpret_cast<T*>(smem + Lo.off_c);
  const int xs = Lo.xs, bs = Lo.bs, ds = Lo.ds, fs = Lo.fs, ws = Lo.ws;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nc = (Lseq + q - 1) / q;
  const float a = A[h];
  const int nng = N / 8;

  const float* dsf = ds_final + ((long)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += NT)
    M[(idx / N) * fs + idx % N] = dsf[idx];

  for (int c = nc - 1; c >= 0; --c) {
    const long t0 = (long)c * q;
    const float* S = s_enter + (((long)b * nc + c) * H + h) * P * N;
    const int rows = min(q, Lseq - (int)t0);  // < q in a short last chunk
    __syncthreads();  // the later chunk is done with every tile
    repro::load_tile(Xs, xs, x + ((b * (long)Lseq + t0) * H + h) * P,
                     (long)H * P, q, rows, P, NT);
    repro::load_tile(DY, ds, dy_g + ((b * (long)Lseq + t0) * H + h) * P,
                     (long)H * P, q, rows, P, NT);
    repro::load_tile(Bs, bs, Bm + (b * (long)Lseq + t0) * N, (long)N, q,
                     rows, N, NT);
    repro::load_tile(Cs, bs, Cm + (b * (long)Lseq + t0) * N, (long)N, q,
                     rows, N, NT);
    for (int j = tid; j < q; j += NT)
      dtv[j] = j < rows ? dt[(b * (long)Lseq + t0 + j) * H + h] : 0.f;
    __syncthreads();
    if (tid < 32) repro::chunk_cumsum(dtv, a, cum, q);
    __syncthreads();
    const float ct = cum[q - 1];
    for (int j = tid; j < q; j += NT) {
      ev[j] = expf(cum[j]);
      dout[j] = expf(ct - cum[j]);
    }
    __syncthreads();

    // ===== row pass: rows [r0b, r0b + RB), every j <= i ====================
    for (int r0b = 0; r0b < q; r0b += RB) {
      // b1 = dcb = dW G dt_j, b2 = gg = dW CB dt_j G; a thread takes a row
      // pair and the 8 columns cg + ncg * k
      const int ncg = q / 8;
      for (int tile = tid; tile < (RB / 2) * ncg; tile += NT) {
        const int cg = tile % ncg, rp = tile / ncg;
        const int r0 = 2 * rp, i0 = r0b + r0;
        int kmax = 0;
        while (kmax < 8 && cg + ncg * kmax <= i0 + 1) ++kmax;
        float dw[2][8], cb[2][8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          dw[0][k] = dw[1][k] = cb[0][k] = cb[1][k] = 0.f;
        if (kmax > 0) {
          for (int p = 0; p < P; p += 8) {
            float d0[8], d1[8];
            load8(DY + (size_t)i0 * ds + p, d0);
            load8(DY + (size_t)(i0 + 1) * ds + p, d1);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if (k < kmax) {
                float xv[8];
                load8(Xs + (size_t)(cg + ncg * k) * xs + p, xv);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  dw[0][k] = fmaf(d0[e], xv[e], dw[0][k]);
                  dw[1][k] = fmaf(d1[e], xv[e], dw[1][k]);
                }
              }
            }
          }
          for (int n = 0; n < N; n += 8) {
            float c0[8], c1[8];
            load8(Cs + (size_t)i0 * bs + n, c0);
            load8(Cs + (size_t)(i0 + 1) * bs + n, c1);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if (k < kmax) {
                float bv[8];
                load8(Bs + (size_t)(cg + ncg * k) * bs + n, bv);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  cb[0][k] = fmaf(c0[e], bv[e], cb[0][k]);
                  cb[1][k] = fmaf(c1[e], bv[e], cb[1][k]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = cg + ncg * k;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int i = i0 + s;
            float v1 = 0.f, v2 = 0.f;
            if (j <= i) {  // mask first: exp only of cum_i - cum_j <= 0
              const float g = expf(cum[i] - cum[j]);
              v1 = dw[s][k] * g * dtv[j];
              v2 = dw[s][k] * cb[s][k] * dtv[j] * g;
            }
            b1[(r0 + s) * ws + j] = v1;
            b2[(r0 + s) * ws + j] = v2;
          }
        }
      }
      __syncthreads();

      // dC rows = dcb . B + exp(cum_i) (dy . S); red = the row's partial
      // sums of C_i . (dy_i . S) over 8 columns. Row pair, 8 columns n0.
      for (int tile = tid; tile < (RB / 2) * nng; tile += NT) {
        const int ng = tile % nng, rp = tile / nng;
        const int r0 = 2 * rp, i0 = r0b + r0, n0 = 8 * ng;
        float acc[2][8], dys[2][8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[0][e] = acc[1][e] = dys[0][e] = dys[1][e] = 0.f;
        for (int j = 0; j <= i0 + 1; ++j) {
          const float w0 = b1[r0 * ws + j], w1 = b1[(r0 + 1) * ws + j];
          float bv[8];
          load8(Bs + (size_t)j * bs + n0, bv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc[0][e] = fmaf(w0, bv[e], acc[0][e]);
            acc[1][e] = fmaf(w1, bv[e], acc[1][e]);
          }
        }
        for (int p = 0; p < P; ++p) {
          const float d0 = DY[(size_t)i0 * ds + p];
          const float d1 = DY[(size_t)(i0 + 1) * ds + p];
          float sv[8];
          load8(S + (size_t)p * N + n0, sv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dys[0][e] = fmaf(d0, sv[e], dys[0][e]);
            dys[1][e] = fmaf(d1, sv[e], dys[1][e]);
          }
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int i = i0 + s;
          float cv[8];
          load8(Cs + (size_t)i * bs + n0, cv);
          float out[8], dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            out[e] = acc[s][e] + ev[i] * dys[s][e];
            dot = fmaf(cv[e], dys[s][e], dot);
          }
          if (i < rows) {
            float* dst =
                dc_part + ((b * (long)Lseq + t0 + i) * H + h) * N + n0;
            reinterpret_cast<float4*>(dst)[0] =
                make_float4(out[0], out[1], out[2], out[3]);
            reinterpret_cast<float4*>(dst)[1] =
                make_float4(out[4], out[5], out[6], out[7]);
          }
          red[(r0 + s) * nng + ng] = dot;
        }
      }
      __syncthreads();
      if (tid < RB) {
        const int i = r0b + tid;
        float rs = 0.f, dot = 0.f;
        for (int j = 0; j <= i; ++j) rs += b2[tid * ws + j];
        for (int g = 0; g < nng; ++g) dot += red[tid * nng + g];
        dcum[i] = rs + ev[i] * dot;
      }
      __syncthreads();
    }

    // ===== column pass: columns [j0, j0 + RB), every i >= j ===============
    const int half = q / 2;
    for (int j0 = 0; j0 < q; j0 += RB) {
      // b1[jl][i] = W, b2[jl][i] = dcb, part[ip][jl] = the pair's share of
      // the column sum of dW CB G. A thread takes the rows ip, ip + q/2 and
      // the 8 columns j0 + 8 cg .. + 8.
      for (int tile = tid; tile < half * (RB / 8); tile += NT) {
        const int ip = tile % half, cg = tile / half;
        const int jb = j0 + 8 * cg;
        const int ii[2] = {ip, ip + half};
        float dw[2][8], cb[2][8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          dw[0][k] = dw[1][k] = cb[0][k] = cb[1][k] = 0.f;
        if (ii[1] >= jb) {
          for (int p = 0; p < P; p += 8) {
            float d0[8], d1[8];
            load8(DY + (size_t)ii[0] * ds + p, d0);
            load8(DY + (size_t)ii[1] * ds + p, d1);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              float xv[8];
              load8(Xs + (size_t)(jb + k) * xs + p, xv);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                dw[0][k] = fmaf(d0[e], xv[e], dw[0][k]);
                dw[1][k] = fmaf(d1[e], xv[e], dw[1][k]);
              }
            }
          }
          for (int n = 0; n < N; n += 8) {
            float c0[8], c1[8];
            load8(Cs + (size_t)ii[0] * bs + n, c0);
            load8(Cs + (size_t)ii[1] * bs + n, c1);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              float bv[8];
              load8(Bs + (size_t)(jb + k) * bs + n, bv);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                cb[0][k] = fmaf(c0[e], bv[e], cb[0][k]);
                cb[1][k] = fmaf(c1[e], bv[e], cb[1][k]);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = jb + k, jl = 8 * cg + k;
          float colv = 0.f;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int i = ii[s];
            float w = 0.f, dc = 0.f;
            if (i >= j) {  // mask first
              const float g = expf(cum[i] - cum[j]);
              w = cb[s][k] * g * dtv[j];
              dc = dw[s][k] * g * dtv[j];
              colv += dw[s][k] * cb[s][k] * g;
            }
            b1[jl * ws + i] = w;
            b2[jl * ws + i] = dc;
          }
          part[ip * RB + jl] = colv;
        }
      }
      __syncthreads();

      // dx columns = W^T . dy + dout_j dt_j (B_j . M^T): a column pair and
      // the 4 p's pg + npg * k
      const int npg = P / 4;
      for (int tile = tid; tile < (RB / 2) * npg; tile += NT) {
        const int pg = tile % npg, jp = tile / npg;
        const int l0 = 2 * jp, jj0 = j0 + l0;
        float acc[2][4], bm[2][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[0][k] = acc[1][k] = bm[0][k] = bm[1][k] = 0.f;
        for (int i = jj0; i < q; ++i) {
          const float w0 = b1[l0 * ws + i], w1 = b1[(l0 + 1) * ws + i];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float d = DY[(size_t)i * ds + pg + npg * k];
            acc[0][k] = fmaf(w0, d, acc[0][k]);
            acc[1][k] = fmaf(w1, d, acc[1][k]);
          }
        }
        for (int n = 0; n < N; n += 8) {
          float b0v[8], b1v[8];
          load8(Bs + (size_t)jj0 * bs + n, b0v);
          load8(Bs + (size_t)(jj0 + 1) * bs + n, b1v);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float mv[8];
            load8(M + (size_t)(pg + npg * k) * fs + n, mv);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              bm[0][k] = fmaf(b0v[e], mv[e], bm[0][k]);
              bm[1][k] = fmaf(b1v[e], mv[e], bm[1][k]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = jj0 + s;
          if (j >= rows) break;
          const float f = dout[j] * dtv[j];
          T* row = dx + ((b * (long)Lseq + t0 + j) * H + h) * P;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            row[pg + npg * k] = from_f<T>(acc[s][k] + f * bm[s][k]);
        }
      }

      // dB columns = dcb^T . C + dout_j dt_j (x_j . M); red = the column's
      // partial sums of (x_j . M) . B_j over 8 columns n0
      for (int tile = tid; tile < (RB / 2) * nng; tile += NT) {
        const int ng = tile % nng, jp = tile / nng;
        const int l0 = 2 * jp, jj0 = j0 + l0, n0 = 8 * ng;
        float acc[2][8], xm[2][8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[0][e] = acc[1][e] = xm[0][e] = xm[1][e] = 0.f;
        for (int i = jj0; i < q; ++i) {
          const float w0 = b2[l0 * ws + i], w1 = b2[(l0 + 1) * ws + i];
          float cv[8];
          load8(Cs + (size_t)i * bs + n0, cv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc[0][e] = fmaf(w0, cv[e], acc[0][e]);
            acc[1][e] = fmaf(w1, cv[e], acc[1][e]);
          }
        }
        for (int p = 0; p < P; ++p) {
          const float x0 = to_f(Xs[(size_t)jj0 * xs + p]);
          const float x1 = to_f(Xs[(size_t)(jj0 + 1) * xs + p]);
          float mv[8];
          load8(M + (size_t)p * fs + n0, mv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            xm[0][e] = fmaf(x0, mv[e], xm[0][e]);
            xm[1][e] = fmaf(x1, mv[e], xm[1][e]);
          }
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = jj0 + s;
          const float f = dout[j] * dtv[j];
          float bv[8];
          load8(Bs + (size_t)j * bs + n0, bv);
          float out[8], dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            out[e] = acc[s][e] + f * xm[s][e];
            dot = fmaf(xm[s][e], bv[e], dot);
          }
          if (j < rows) {
            float* dst =
                db_part + ((b * (long)Lseq + t0 + j) * H + h) * N + n0;
            reinterpret_cast<float4*>(dst)[0] =
                make_float4(out[0], out[1], out[2], out[3]);
            reinterpret_cast<float4*>(dst)[1] =
                make_float4(out[4], out[5], out[6], out[7]);
          }
          red[(l0 + s) * nng + ng] = dot;
        }
      }
      __syncthreads();
      if (tid < RB) {
        const int j = j0 + tid;
        float cs = 0.f, d = 0.f;
        for (int ip = 0; ip < half; ++ip) cs += part[ip * RB + tid];
        for (int g = 0; g < nng; ++g) d += red[tid * nng + g];
        di[j] = d;
        ddt_a[j] = cs + d * dout[j];
        colgg[j] = cs * dtv[j];
      }
      __syncthreads();
    }

    // ===== d cum -> ddt, dA; sum(M o S) for dct ==========================
    {
      float ms = 0.f;
      for (int idx = tid; idx < P * N; idx += NT)
        ms = fmaf(M[(idx / N) * fs + idx % N], S[idx], ms);
      red[tid] = ms;
    }
    __syncthreads();
    if (tid == 0) {
      float msum = 0.f, dct = 0.f;
      for (int t = 0; t < NT; ++t) msum += red[t];
      for (int j = 0; j < q; ++j) {
        const float v = di[j] * dout[j] * dtv[j];
        dct += v;
        dcum[j] = dcum[j] - colgg[j] - v;
      }
      dct += expf(ct) * msum;
      dcum[q - 1] += dct;  // ct = cum[q - 1]
      float run = 0.f, da = 0.f;
      for (int j = q - 1; j >= 0; --j) {  // dA_j = sum_{i >= j} dcum_i
        run += dcum[j];
        if (j < rows)
          ddt[(b * (long)Lseq + t0 + j) * H + h] = ddt_a[j] + run * a;
        da = fmaf(run, dtv[j], da);
      }
      da_part[((long)b * nc + c) * H + h] = da;
    }

    // ===== carry: M <- exp(ct) M + (dy o exp(cum))^T . C =================
    const float ect = expf(ct);
    for (int tile = tid; tile < (P / 4) * nng; tile += NT) {
      const int ng = tile % nng, pg = tile / nng;
      const int p0 = 4 * pg, n0 = 8 * ng;
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
      for (int i = 0; i < q; ++i) {
        float cv[8];
        load8(Cs + (size_t)i * bs + n0, cv);
        const float ei = ev[i];
        float dv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) dv[r] = DY[(size_t)i * ds + p0 + r] * ei;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(dv[r], cv[e], acc[r][e]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float* m = M + (size_t)(p0 + r) * fs + n0 + e;
          *m = ect * *m + acc[r][e];
        }
    }
  }
}

// dB / dC [rows, N] = sum over h of the per-head partials [rows, H, N], in
// head order, cast to T.
template <typename T>
__global__ void ssd_head_sum_kernel(const float* __restrict__ db_part,
                                    const float* __restrict__ dc_part,
                                    T* __restrict__ db, T* __restrict__ dc,
                                    long rows, int H, int N) {
  const long idx = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (idx >= rows * N) return;
  const long r = idx / N;
  const int n = (int)(idx - r * N);
  const float* pb = db_part + r * H * N + n;
  const float* pc = dc_part + r * H * N + n;
  float sb = 0.f, sc = 0.f;
  for (int hh = 0; hh < H; ++hh) {
    sb += pb[(long)hh * N];
    sc += pc[(long)hh * N];
  }
  db[idx] = from_f<T>(sb);
  dc[idx] = from_f<T>(sc);
}

template <typename T>
int launch_bwd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* s_enter, const void* dy,
               const void* ds_final, void* dx, void* ddt, void* da_part,
               void* db_part, void* dc_part, void* db, void* dc, int Bsz,
               int Lseq, int H, int P, int N, int q, cudaStream_t st) {
  const size_t bytes = bwd_layout<T>(q, P, N).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return repro::refused(err);
  ssd_bwd_kernel<T><<<dim3(H, Bsz), NT, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(s_enter),
      static_cast<const float*>(dy), static_cast<const float*>(ds_final),
      static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(da_part), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), Lseq, H, P, N, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)Bsz * Lseq;
  const int threads = 256;
  const long blocks = (rows * N + threads - 1) / threads;
  ssd_head_sum_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
      static_cast<T*>(db), static_cast<T*>(dc), rows, H, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm,
                            const void* s_enter, const void* dy,
                            const void* ds_final, void* dx, void* ddt,
                            void* da_part, void* db_part, void* dc_part,
                            void* db, void* dc, int Bsz, int Lseq, int H,
                            int P, int N, int q, int dtype, void* stream) {
  if (repro::bad_ssd_shape(Bsz, Lseq, H, P, N, q))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return launch_bwd<float>(x, dt, A, Bm, Cm, s_enter, dy, ds_final, dx, ddt,
                             da_part, db_part, dc_part, db, dc, Bsz, Lseq, H,
                             P, N, q, st);
  return launch_bwd<__nv_bfloat16>(x, dt, A, Bm, Cm, s_enter, dy, ds_final,
                                   dx, ddt, da_part, db_part, dc_part, db, dc,
                                   Bsz, Lseq, H, P, N, q, st);
}
