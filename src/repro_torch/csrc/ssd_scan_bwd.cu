// Chunked Mamba2 SSD scan, backward (K7), for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
// `_ssd_bwd_kernel` behind `ssd_scan_bwd`. Inputs as K6 (x, B, C in one
// dtype, f32 or bf16; dt, A f32), plus each chunk's entering state
// s_enter [B,NC,H,P,N] f32 from K6, and the cotangents dy [B,L,H,P] f32 and
// ds_final [B,H,P,N] f32. Outputs dx [B,L,H,P] (x's dtype), ddt [B,L,H] f32,
// per-(batch, chunk, head) dA partials [B,NC,H] f32 (scratch, which the
// second kernel sums to dA [H], as the reference's wrapper sums them), and
// dB, dC [B,L,N] (B's dtype).
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
// dx, ddt, dA, dB, dC (~670 MB), ~0.20 ms at 3.35 TB/s; its products are
// ~50 MFLOP a (batch, chunk, head), ~0.3 ms on the tensor cores at peak.
//
// Tensor-core body (bf16, chunk <= 128, P <= 64, N <= 128: every shape of
// the main paths). One CTA of 8 warps per (head, batch row) walks the chunks
// in reverse. Every product runs on mma.sync m16n8k16 (bf16 in, f32
// accumulate) from ldmatrix fragments of bf16 tiles in shared memory: x, B,
// C exact; the f32 operands split into bf16 terms. dy and S take two (hi +
// lo: dy.S as hi.hi + hi.lo + lo.hi; a training step's dy is bf16 already).
// W, dcb, M and e o C take three (hi + mid + lo, f32's precision), one
// product a term against an exact operand and five (hi.hi, hi.lo, mid.hi,
// mid.lo, lo.hi) against dy: they feed the bf16 outputs, dB and dC after a
// sum over the heads, and the carry of M across chunks, where two terms'
// ~2^-17 moved training steps measurably against the FMA body's f32. No
// TF32. The [q,q] matrices never leave
// registers: warp w owns the 16-row block rb (0-3 for warps 0-3, 7-4 for
// 4-7, so that each SM sub-partition holds blocks k and 7 - k and the same
// work). Its row pass walks the 16-column tiles j <= i: C.B^T and dy.x^T
// tiles, G = exp(cum_i - cum_j) masked first, dcb and the row sums of gg in
// registers, and dcb's tile goes straight on as the A fragment of
// dC += dcb.B, which started as exp(cum) o (dy.S). Its column pass walks the
// 16-row tiles i >= j of the transposes, B.C^T and x.dy^T, whose W^T and
// dcb^T tiles feed dx += W^T.dy and dB += dcb^T.C the same way, with the
// column sums of gg; dx started as f o (B.M^T), dB as f o (x.M), f =
// exp(ct - cum) dt. Each [q,q] tile is so computed twice, once a pass: a
// pass keeps only 16 x 16 of each in registers and needs no [q,q] buffer in
// shared memory, which at N 128 holds the bf16 tiles of x, dy (hi, lo), B,
// C, S (hi, lo) and M (hi, mid, lo) and nothing more (212 KB). M's f32
// master lives in the registers of the carry M <- exp(ct) M + dy^T.(e o C),
// which every warp computes for a 16 x N/2 block and writes back in three
// terms for the next chunk. sum(M o S) is taken while S loads. d cum, its reverse cumsum, ddt
// and the chunk's dA partial: one warp, shuffles in a fixed order.
//
// FMA body (f32, or bf16 shapes the tensor-core body does not take): one
// CTA of 256 threads per (head, batch row) walks the chunks in reverse; M
// lives in shared memory across chunks, S is read from global memory (L2).
// The [q,q] matrices do not fit shared memory beside the tiles, so they are
// built in blocks of RB = 32: a row pass (rows i, all j <= i) that
// completes dC and the row sums of gg, and a column pass (columns j, all
// i >= j) that rebuilds dW and CB for its columns and completes dx, dB and
// the column sums. Row strides in shared memory carry one extra 16-byte
// unit, as in K6.
//
// Both bodies write per-head f32 dB / dC partials [B,L,H,N] (the TPU summed
// them over heads by revisiting one output block on consecutive grid steps;
// CUDA CTAs of different heads run in parallel) and per-(batch, chunk, head)
// dA partials; a second kernel sums the heads' partials in head order and
// casts them, and the dA partials over (batch, chunk) in order. No atomics:
// two runs agree bit for bit.

#include "common.cuh"
#include "hopper.cuh"

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

// ===========================================================================
// Tensor-core body (bf16): see the note at the top
// ===========================================================================

namespace tc {

namespace hp = repro::hopper;
using bf16 = __nv_bfloat16;

constexpr int NTH = 256;      // 8 warps
constexpr int QMAX = 128;     // chunk rows
constexpr int PT = 64;        // P, padded with zeros
constexpr int XS = PT + 8;    // row stride of the [q][P] tiles (144 bytes)

// bf16 tiles, row strides an odd number of 16-byte units (ldmatrix without
// bank conflicts), then 8 f32 vectors of QMAX and NTH f32 for a reduction
template <int NN>
struct Lay {
  static constexpr int BS = NN + 8;                    // [.][N] row stride
  static constexpr size_t XT = (size_t)QMAX * XS * 2;  // a [q][P] tile
  static constexpr size_t BT = (size_t)QMAX * BS * 2;  // a [q][N] tile
  static constexpr size_t PN = (size_t)PT * BS * 2;    // a [P][N] tile
  static constexpr size_t b = 0, c = BT, x = 2 * BT, dyh = 2 * BT + XT,
                          dyl = 2 * BT + 2 * XT, sh = 2 * BT + 3 * XT,
                          sl = sh + PN, mh = sl + PN, mm = mh + PN,
                          ml = mm + PN, vec = ml + PN,
                          red = vec + 8 * QMAX * 4,
                          bytes = red + NTH * 4;
};

template <int NN>
__global__ void __launch_bounds__(NTH, 1)
ssd_bwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm,
                  const float* __restrict__ s_enter,
                  const float* __restrict__ dy_g,
                  const float* __restrict__ ds_final, bf16* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ da_part,
                  float* __restrict__ db_part, float* __restrict__ dc_part,
                  int Lseq, int H, int P, int N, int q) {
  using L = Lay<NN>;
  constexpr int BS = L::BS;
  constexpr int NN8 = NN / 8;        // n8 tiles across N
  constexpr int NP8 = PT / 8;        // n8 tiles across P
  constexpr int CN8 = NN / 16;       // n8 tiles of a warp's carry block
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem + L::b);
  bf16* Cs = reinterpret_cast<bf16*>(smem + L::c);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::x);
  bf16* DYh = reinterpret_cast<bf16*>(smem + L::dyh);
  bf16* DYl = reinterpret_cast<bf16*>(smem + L::dyl);
  bf16* Sh = reinterpret_cast<bf16*>(smem + L::sh);
  bf16* Sl = reinterpret_cast<bf16*>(smem + L::sl);
  bf16* Mh = reinterpret_cast<bf16*>(smem + L::mh);
  bf16* Mm = reinterpret_cast<bf16*>(smem + L::mm);
  bf16* Ml = reinterpret_cast<bf16*>(smem + L::ml);
  float* dtv = reinterpret_cast<float*>(smem + L::vec);
  float* cum = dtv + QMAX;
  float* ev = cum + QMAX;      // exp(cum)
  float* dout = ev + QMAX;     // exp(ct - cum)
  float* dcr = dout + QMAX;    // row part of d cum
  float* csum = dcr + QMAX;    // column sums of dW o CB o G
  float* xmb = csum + QMAX;    // (x . M) . B, a row
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const hp::Lane ln(lane);
  const int nc = (Lseq + q - 1) / q, nb = q / 16;
  const float a = A[h];
  const int rb = warp < 4 ? warp : 11 - warp;
  const long hp_row = (long)H * P, hn_row = (long)H * N;

  // the carry's block: p rows [pc0, pc0 + 16), n columns [nc0, nc0 + NN/2)
  const int pc0 = 16 * (warp & 3), nc0 = (warp >> 2) * (NN / 2);
  float Mr[CN8][4];
  auto store_m = [&]() {
#pragma unroll
    for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int o = (pc0 + g + 8 * hf) * BS + nc0 + 8 * nt + 2 * t4;
        uint32_t hi, mi, lo;
        hp::split3(Mr[nt][2 * hf], Mr[nt][2 * hf + 1], hi, mi, lo);
        *reinterpret_cast<uint32_t*>(Mh + o) = hi;
        *reinterpret_cast<uint32_t*>(Mm + o) = mi;
        *reinterpret_cast<uint32_t*>(Ml + o) = lo;
      }
  };
  {
    const float* dsf = ds_final + ((long)b * H + h) * P * N;
#pragma unroll
    for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = pc0 + g + 8 * hf, n = nc0 + 8 * nt + 2 * t4;
        const float2 m = p < P && n < N
                             ? *reinterpret_cast<const float2*>(dsf + p * N + n)
                             : make_float2(0.f, 0.f);
        Mr[nt][2 * hf] = m.x;
        Mr[nt][2 * hf + 1] = m.y;
      }
    store_m();
  }

  for (int c = nc - 1; c >= 0; --c) {
    const long t0 = (long)c * q;
    const int rows = min(q, Lseq - (int)t0);  // < q in a short last chunk
    // x, B, C by cp.async; rows past `rows` and columns past P, N as zeros
    {
      const bf16* xg = x + ((b * (long)Lseq + t0) * H + h) * P;
      for (int idx = tid; idx < q * (PT / 8); idx += NTH) {
        const int r = idx / (PT / 8), cc = (idx % (PT / 8)) * 8;
        const bool ok = r < rows && cc < P;
        hp::cp_async16(Xs + r * XS + cc, ok ? xg + r * hp_row + cc : xg, ok);
      }
      const bf16* bg = Bm + (b * (long)Lseq + t0) * N;
      const bf16* cg = Cm + (b * (long)Lseq + t0) * N;
      for (int idx = tid; idx < q * (NN / 8); idx += NTH) {
        const int r = idx / (NN / 8), cc = (idx % (NN / 8)) * 8;
        const bool ok = r < rows && cc < N;
        hp::cp_async16(Bs + r * BS + cc, ok ? bg + (long)r * N + cc : bg, ok);
        hp::cp_async16(Cs + r * BS + cc, ok ? cg + (long)r * N + cc : cg, ok);
      }
      hp::cp_async_commit();
    }
    for (int j = tid; j < q; j += NTH)
      dtv[j] = j < rows ? dt[(b * (long)Lseq + t0 + j) * H + h] : 0.f;
    {  // dy -> hi, lo
      const float* dyg = dy_g + ((b * (long)Lseq + t0) * H + h) * P;
      for (int idx = tid; idx < q * (PT / 4); idx += NTH) {
        const int r = idx / (PT / 4), cc = (idx % (PT / 4)) * 4;
        const float4 v =
            r < rows && cc < P
                ? *reinterpret_cast<const float4*>(dyg + r * hp_row + cc)
                : make_float4(0.f, 0.f, 0.f, 0.f);
        uint2 hi, lo;
        hp::split2(v.x, v.y, hi.x, lo.x);
        hp::split2(v.z, v.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(DYh + r * XS + cc) = hi;
        *reinterpret_cast<uint2*>(DYl + r * XS + cc) = lo;
      }
    }
    {  // S -> hi, lo over the carry's block, and sum(M o S) there
      const float* Sg = s_enter + (((long)b * nc + c) * H + h) * P * N;
      float ms = 0.f;
#pragma unroll
      for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = pc0 + g + 8 * hf, n = nc0 + 8 * nt + 2 * t4;
          const float2 sv =
              p < P && n < N ? *reinterpret_cast<const float2*>(Sg + p * N + n)
                             : make_float2(0.f, 0.f);
          ms = fmaf(Mr[nt][2 * hf], sv.x, ms);
          ms = fmaf(Mr[nt][2 * hf + 1], sv.y, ms);
          uint32_t hi, lo;
          hp::split2(sv.x, sv.y, hi, lo);
          *reinterpret_cast<uint32_t*>(Sh + p * BS + n) = hi;
          *reinterpret_cast<uint32_t*>(Sl + p * BS + n) = lo;
        }
      red[tid] = ms;
    }
    hp::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) repro::chunk_cumsum(dtv, a, cum, q);
    __syncthreads();
    const float ct = cum[q - 1];
    for (int j = tid; j < q; j += NTH) {
      ev[j] = expf(cum[j]);
      dout[j] = expf(ct - cum[j]);
    }
    __syncthreads();

    if (rb < nb) {
      // ===== row pass: rows i of block rb, columns j <= i ==================
      const int i0 = 16 * rb, ia = i0 + g, ib = ia + 8;
      {
        float dc[NN8][4];
#pragma unroll
        for (int nt = 0; nt < NN8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dc[nt][e] = 0.f;
        // dy . S (hi.hi + hi.lo + lo.hi)
#pragma unroll
        for (int kk = 0; kk < PT / 16; ++kk) {
          uint32_t ah[4], al[4];
          hp::ldsm4(ah, DYh + (i0 + ln.a_r) * XS + kk * 16 + ln.a_c);
          hp::ldsm4(al, DYl + (i0 + ln.a_r) * XS + kk * 16 + ln.a_c);
#pragma unroll
          for (int np = 0; np < NN / 16; ++np) {
            uint32_t bh[4], bl[4];
            const int o = (kk * 16 + ln.bt_k) * BS + np * 16 + ln.bt_n;
            hp::ldsm4_t(bh, Sh + o);
            hp::ldsm4_t(bl, Sl + o);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              hp::mma16816(dc[2 * np + u], ah, bh[2 * u], bh[2 * u + 1]);
              hp::mma16816(dc[2 * np + u], ah, bl[2 * u], bl[2 * u + 1]);
              hp::mma16816(dc[2 * np + u], al, bh[2 * u], bh[2 * u + 1]);
            }
          }
        }
        // C_i . (dy . S)_i, then dC starts from exp(cum_i) (dy . S)_i
        float rda = 0.f, rdb = 0.f;
#pragma unroll
        for (int nt = 0; nt < NN8; ++nt) {
          const int n = 8 * nt + 2 * t4;
          const float2 ca = hp::unpack_bf16(
              *reinterpret_cast<const uint32_t*>(Cs + ia * BS + n));
          const float2 cb = hp::unpack_bf16(
              *reinterpret_cast<const uint32_t*>(Cs + ib * BS + n));
          rda = fmaf(ca.x, dc[nt][0], fmaf(ca.y, dc[nt][1], rda));
          rdb = fmaf(cb.x, dc[nt][2], fmaf(cb.y, dc[nt][3], rdb));
        }
        rda += __shfl_xor_sync(0xffffffffu, rda, 1);
        rda += __shfl_xor_sync(0xffffffffu, rda, 2);
        rdb += __shfl_xor_sync(0xffffffffu, rdb, 1);
        rdb += __shfl_xor_sync(0xffffffffu, rdb, 2);
        const float eia = ev[ia], eib = ev[ib];
#pragma unroll
        for (int nt = 0; nt < NN8; ++nt) {
          dc[nt][0] *= eia;
          dc[nt][1] *= eia;
          dc[nt][2] *= eib;
          dc[nt][3] *= eib;
        }
        const float cia = cum[ia], cib = cum[ib];
        float rsa = 0.f, rsb = 0.f;
        for (int jt = 0; jt <= rb; ++jt) {
          const int j0 = 16 * jt;
          float cbm[2][4] = {}, dw[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < NN / 16; ++kk) {
            uint32_t af[4], bf[4];
            hp::ldsm4(af, Cs + (i0 + ln.a_r) * BS + kk * 16 + ln.a_c);
            hp::ldsm4(bf, Bs + (j0 + ln.b_n) * BS + kk * 16 + ln.b_k);
            hp::mma16816(cbm[0], af, bf[0], bf[1]);
            hp::mma16816(cbm[1], af, bf[2], bf[3]);
          }
#pragma unroll
          for (int kk = 0; kk < PT / 16; ++kk) {
            uint32_t ah[4], al[4], bf[4];
            hp::ldsm4(ah, DYh + (i0 + ln.a_r) * XS + kk * 16 + ln.a_c);
            hp::ldsm4(al, DYl + (i0 + ln.a_r) * XS + kk * 16 + ln.a_c);
            hp::ldsm4(bf, Xs + (j0 + ln.b_n) * XS + kk * 16 + ln.b_k);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              hp::mma16816(dw[u], ah, bf[2 * u], bf[2 * u + 1]);
              hp::mma16816(dw[u], al, bf[2 * u], bf[2 * u + 1]);
            }
          }
          // dcb = dW G dt_j, gg = dcb CB; masked before the exponential
          float dcb[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? ia : ib;
              const int j = j0 + 8 * u + 2 * t4 + (e & 1);
              float v = 0.f;
              if (j <= i) {
                v = dw[u][e] * expf((e < 2 ? cia : cib) - cum[j]) * dtv[j];
                if (e < 2)
                  rsa = fmaf(v, cbm[u][e], rsa);
                else
                  rsb = fmaf(v, cbm[u][e], rsb);
              }
              dcb[u][e] = v;
            }
          uint32_t dh[4], dm[4], dl[4];
          hp::a_split3(dh, dm, dl, dcb[0], dcb[1]);
#pragma unroll
          for (int np = 0; np < NN / 16; ++np) {
            uint32_t bf[4];
            hp::ldsm4_t(bf, Bs + (j0 + ln.bt_k) * BS + np * 16 + ln.bt_n);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              hp::mma16816(dc[2 * np + u], dh, bf[2 * u], bf[2 * u + 1]);
              hp::mma16816(dc[2 * np + u], dm, bf[2 * u], bf[2 * u + 1]);
              hp::mma16816(dc[2 * np + u], dl, bf[2 * u], bf[2 * u + 1]);
            }
          }
        }
        rsa += __shfl_xor_sync(0xffffffffu, rsa, 1);
        rsa += __shfl_xor_sync(0xffffffffu, rsa, 2);
        rsb += __shfl_xor_sync(0xffffffffu, rsb, 1);
        rsb += __shfl_xor_sync(0xffffffffu, rsb, 2);
        if (t4 == 0) {
          dcr[ia] = rsa + eia * rda;
          dcr[ib] = rsb + eib * rdb;
        }
        float* dcg = dc_part + ((b * (long)Lseq + t0) * H + h) * N;
#pragma unroll
        for (int nt = 0; nt < NN8; ++nt) {
          const int n = 8 * nt + 2 * t4;
          if (n < N) {
            if (ia < rows)
              *reinterpret_cast<float2*>(dcg + ia * hn_row + n) =
                  make_float2(dc[nt][0], dc[nt][1]);
            if (ib < rows)
              *reinterpret_cast<float2*>(dcg + ib * hn_row + n) =
                  make_float2(dc[nt][2], dc[nt][3]);
          }
        }
      }

      // ===== column pass: rows j of block rb (of the transposes), i >= j ===
      {
        const int j0 = i0, ja = ia, jb = ib;
        float dxa[NP8][4], dba[NN8][4];
#pragma unroll
        for (int nt = 0; nt < NP8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dxa[nt][e] = 0.f;
#pragma unroll
        for (int nt = 0; nt < NN8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dba[nt][e] = 0.f;
        // B . M^T (K = n) and x . M (K = p), M as hi + lo
#pragma unroll
        for (int kk = 0; kk < NN / 16; ++kk) {
          uint32_t af[4];
          hp::ldsm4(af, Bs + (j0 + ln.a_r) * BS + kk * 16 + ln.a_c);
#pragma unroll
          for (int pp = 0; pp < PT / 16; ++pp) {
            uint32_t bh[4], bm[4], bl[4];
            const int o = (pp * 16 + ln.b_n) * BS + kk * 16 + ln.b_k;
            hp::ldsm4(bh, Mh + o);
            hp::ldsm4(bm, Mm + o);
            hp::ldsm4(bl, Ml + o);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              hp::mma16816(dxa[2 * pp + u], af, bh[2 * u], bh[2 * u + 1]);
              hp::mma16816(dxa[2 * pp + u], af, bm[2 * u], bm[2 * u + 1]);
              hp::mma16816(dxa[2 * pp + u], af, bl[2 * u], bl[2 * u + 1]);
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < PT / 16; ++kk) {
          uint32_t af[4];
          hp::ldsm4(af, Xs + (j0 + ln.a_r) * XS + kk * 16 + ln.a_c);
#pragma unroll
          for (int np = 0; np < NN / 16; ++np) {
            uint32_t bh[4], bm[4], bl[4];
            const int o = (kk * 16 + ln.bt_k) * BS + np * 16 + ln.bt_n;
            hp::ldsm4_t(bh, Mh + o);
            hp::ldsm4_t(bm, Mm + o);
            hp::ldsm4_t(bl, Ml + o);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              hp::mma16816(dba[2 * np + u], af, bh[2 * u], bh[2 * u + 1]);
              hp::mma16816(dba[2 * np + u], af, bm[2 * u], bm[2 * u + 1]);
              hp::mma16816(dba[2 * np + u], af, bl[2 * u], bl[2 * u + 1]);
            }
          }
        }
        // di_j = (x . M)_j . B_j; dx and dB start from f_j (B.M^T), f_j (x.M)
        float dia = 0.f, dib = 0.f;
#pragma unroll
        for (int nt = 0; nt < NN8; ++nt) {
          const int n = 8 * nt + 2 * t4;
          const float2 ba = hp::unpack_bf16(
              *reinterpret_cast<const uint32_t*>(Bs + ja * BS + n));
          const float2 bb = hp::unpack_bf16(
              *reinterpret_cast<const uint32_t*>(Bs + jb * BS + n));
          dia = fmaf(ba.x, dba[nt][0], fmaf(ba.y, dba[nt][1], dia));
          dib = fmaf(bb.x, dba[nt][2], fmaf(bb.y, dba[nt][3], dib));
        }
        dia += __shfl_xor_sync(0xffffffffu, dia, 1);
        dia += __shfl_xor_sync(0xffffffffu, dia, 2);
        dib += __shfl_xor_sync(0xffffffffu, dib, 1);
        dib += __shfl_xor_sync(0xffffffffu, dib, 2);
        if (t4 == 0) {
          xmb[ja] = dia;
          xmb[jb] = dib;
        }
        const float cja = cum[ja], cjb = cum[jb], dja = dtv[ja],
                    djb = dtv[jb];
        const float fa = dout[ja] * dja, fb = dout[jb] * djb;
#pragma unroll
        for (int nt = 0; nt < NP8; ++nt) {
          dxa[nt][0] *= fa;
          dxa[nt][1] *= fa;
          dxa[nt][2] *= fb;
          dxa[nt][3] *= fb;
        }
#pragma unroll
        for (int nt = 0; nt < NN8; ++nt) {
          dba[nt][0] *= fa;
          dba[nt][1] *= fa;
          dba[nt][2] *= fb;
          dba[nt][3] *= fb;
        }
        float csa = 0.f, csb = 0.f;
        for (int it = rb; it < nb; ++it) {
          const int c0 = 16 * it;       // the tile's rows i of the chunk
          float cbt[2][4] = {}, dwt[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < NN / 16; ++kk) {
            uint32_t af[4], bf[4];
            hp::ldsm4(af, Bs + (j0 + ln.a_r) * BS + kk * 16 + ln.a_c);
            hp::ldsm4(bf, Cs + (c0 + ln.b_n) * BS + kk * 16 + ln.b_k);
            hp::mma16816(cbt[0], af, bf[0], bf[1]);
            hp::mma16816(cbt[1], af, bf[2], bf[3]);
          }
#pragma unroll
          for (int kk = 0; kk < PT / 16; ++kk) {
            uint32_t af[4], bh[4], bl[4];
            hp::ldsm4(af, Xs + (j0 + ln.a_r) * XS + kk * 16 + ln.a_c);
            const int o = (c0 + ln.b_n) * XS + kk * 16 + ln.b_k;
            hp::ldsm4(bh, DYh + o);
            hp::ldsm4(bl, DYl + o);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              hp::mma16816(dwt[u], af, bh[2 * u], bh[2 * u + 1]);
              hp::mma16816(dwt[u], af, bl[2 * u], bl[2 * u + 1]);
            }
          }
          // W^T = CB^T G dt_j, dcb^T = dW^T G dt_j; column sums of dW CB G
          float wv[2][4], dv[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = e < 2 ? ja : jb;
              const int i = c0 + 8 * u + 2 * t4 + (e & 1);
              float w = 0.f, d = 0.f;
              if (i >= j) {
                const float gx = expf(cum[i] - (e < 2 ? cja : cjb));
                const float dj = e < 2 ? dja : djb;
                w = cbt[u][e] * gx * dj;
                d = dwt[u][e] * gx * dj;
                if (e < 2)
                  csa = fmaf(dwt[u][e] * cbt[u][e], gx, csa);
                else
                  csb = fmaf(dwt[u][e] * cbt[u][e], gx, csb);
              }
              wv[u][e] = w;
              dv[u][e] = d;
            }
          {
            uint32_t wh[4], wm[4], wl[4];
            hp::a_split3(wh, wm, wl, wv[0], wv[1]);
#pragma unroll
            for (int pp = 0; pp < PT / 16; ++pp) {
              uint32_t bh[4], bl[4];
              const int o = (c0 + ln.bt_k) * XS + pp * 16 + ln.bt_n;
              hp::ldsm4_t(bh, DYh + o);
              hp::ldsm4_t(bl, DYl + o);
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                float (&d)[4] = dxa[2 * pp + u];
                hp::mma16816(d, wh, bh[2 * u], bh[2 * u + 1]);
                hp::mma16816(d, wh, bl[2 * u], bl[2 * u + 1]);
                hp::mma16816(d, wm, bh[2 * u], bh[2 * u + 1]);
                hp::mma16816(d, wm, bl[2 * u], bl[2 * u + 1]);
                hp::mma16816(d, wl, bh[2 * u], bh[2 * u + 1]);
              }
            }
          }
          {
            uint32_t dh[4], dm[4], dl[4];
            hp::a_split3(dh, dm, dl, dv[0], dv[1]);
#pragma unroll
            for (int np = 0; np < NN / 16; ++np) {
              uint32_t bf[4];
              hp::ldsm4_t(bf, Cs + (c0 + ln.bt_k) * BS + np * 16 + ln.bt_n);
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                hp::mma16816(dba[2 * np + u], dh, bf[2 * u], bf[2 * u + 1]);
                hp::mma16816(dba[2 * np + u], dm, bf[2 * u], bf[2 * u + 1]);
                hp::mma16816(dba[2 * np + u], dl, bf[2 * u], bf[2 * u + 1]);
              }
            }
          }
        }
        csa += __shfl_xor_sync(0xffffffffu, csa, 1);
        csa += __shfl_xor_sync(0xffffffffu, csa, 2);
        csb += __shfl_xor_sync(0xffffffffu, csb, 1);
        csb += __shfl_xor_sync(0xffffffffu, csb, 2);
        if (t4 == 0) {
          csum[ja] = csa;
          csum[jb] = csb;
        }
        bf16* dxg = dx + ((b * (long)Lseq + t0) * H + h) * P;
#pragma unroll
        for (int nt = 0; nt < NP8; ++nt) {
          const int p = 8 * nt + 2 * t4;
          if (p < P) {
            if (ja < rows)
              *reinterpret_cast<uint32_t*>(dxg + ja * hp_row + p) =
                  hp::pack_bf16(dxa[nt][0], dxa[nt][1]);
            if (jb < rows)
              *reinterpret_cast<uint32_t*>(dxg + jb * hp_row + p) =
                  hp::pack_bf16(dxa[nt][2], dxa[nt][3]);
          }
        }
        float* dbg = db_part + ((b * (long)Lseq + t0) * H + h) * N;
#pragma unroll
        for (int nt = 0; nt < NN8; ++nt) {
          const int n = 8 * nt + 2 * t4;
          if (n < N) {
            if (ja < rows)
              *reinterpret_cast<float2*>(dbg + ja * hn_row + n) =
                  make_float2(dba[nt][0], dba[nt][1]);
            if (jb < rows)
              *reinterpret_cast<float2*>(dbg + jb * hn_row + n) =
                  make_float2(dba[nt][2], dba[nt][3]);
          }
        }
      }
    }
    __syncthreads();

    // ===== d cum -> ddt, dA (warp 0, fixed orders) ==========================
    if (warp == 0) {
      float msum = 0.f;
      for (int k = 0; k < NTH / 32; ++k) msum += red[lane * (NTH / 32) + k];
      msum = repro::warp_sum(msum);
      const int per = q / 32;                 // 1..4 rows a lane
      float dcl[4], dctp = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dcl[k] = 0.f;
        if (k < per) {
          const int j = lane * per + k;
          const float v = xmb[j] * dout[j] * dtv[j];
          dctp += v;
          dcl[k] = dcr[j] - csum[j] * dtv[j] - v;
        }
      }
      const float dct = repro::warp_sum(dctp) + expf(ct) * msum;
#pragma unroll
      for (int k = 0; k < 4; ++k)             // ct = cum[q - 1]
        if (lane == 31 && k == per - 1) dcl[k] += dct;
      // dA_j = sum_{i >= j} dcum_i: a reverse scan, the lane's rows then
      // the lanes above it
      float suf[4], run = 0.f;
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        run += dcl[k];
        suf[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      float above = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) above = 0.f;
      float da = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < per) {
          const int j = lane * per + k;
          const float r = suf[k] + above;
          if (j < rows)
            ddt[(b * (long)Lseq + t0 + j) * H + h] =
                csum[j] + xmb[j] * dout[j] + r * a;
          da = fmaf(r, dtv[j], da);
        }
      }
      da = repro::warp_sum(da);
      if (lane == 0) da_part[((long)b * nc + c) * H + h] = da;
    }

    // ===== carry: M <- exp(ct) M + dy^T . (exp(cum) o C) ===================
    {
      float acc[CN8][4];
#pragma unroll
      for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      for (int kk = 0; kk < nb; ++kk) {
        uint32_t ah[4], al[4];
        const int o = (kk * 16 + ln.at_k) * XS + pc0 + ln.at_m;
        hp::ldsm4_t(ah, DYh + o);
        hp::ldsm4_t(al, DYl + o);
        const int k0 = kk * 16 + 2 * t4;
        const float e0 = ev[k0], e1 = ev[k0 + 1], e8 = ev[k0 + 8],
                    e9 = ev[k0 + 9];
#pragma unroll
        for (int np = 0; np < CN8 / 2; ++np) {
          uint32_t bf[4], bh[4], bm[4], bl[4];
          hp::ldsm4_t(bf, Cs + (kk * 16 + ln.bt_k) * BS + nc0 + np * 16 +
                              ln.bt_n);
#pragma unroll
          for (int r = 0; r < 4; ++r) {     // odd registers: rows k + 8
            const float2 f = hp::unpack_bf16(bf[r]);
            hp::split3(f.x * (r & 1 ? e8 : e0), f.y * (r & 1 ? e9 : e1),
                       bh[r], bm[r], bl[r]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float (&d)[4] = acc[2 * np + u];
            hp::mma16816(d, ah, bh[2 * u], bh[2 * u + 1]);
            hp::mma16816(d, ah, bm[2 * u], bm[2 * u + 1]);
            hp::mma16816(d, ah, bl[2 * u], bl[2 * u + 1]);
            hp::mma16816(d, al, bh[2 * u], bh[2 * u + 1]);
            hp::mma16816(d, al, bm[2 * u], bm[2 * u + 1]);
          }
        }
      }
      const float ect = expf(ct);
#pragma unroll
      for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) Mr[nt][e] = ect * Mr[nt][e] + acc[nt][e];
      store_m();
    }
    __syncthreads();
  }
}

}  // namespace tc

// dB / dC [rows, N] = sum over h of the per-head partials [rows, H, N], in
// head order, cast to T; dA [H] = the (batch, chunk) partials [nbc, H]
// summed in order.
template <typename T>
__global__ void ssd_head_sum_kernel(const float* __restrict__ db_part,
                                    const float* __restrict__ dc_part,
                                    T* __restrict__ db, T* __restrict__ dc,
                                    const float* __restrict__ da_part,
                                    float* __restrict__ da, long rows, int H,
                                    int N, int nbc) {
  const long idx = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (idx < H) {
    float s = 0.f;
    for (int r = 0; r < nbc; ++r) s += da_part[(long)r * H + idx];
    da[idx] = s;
  }
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

// whether the tensor-core body takes the shape (bf16 only)
bool tc_body(int P, int N, int q) { return q <= tc::QMAX && P <= tc::PT && N <= 128; }

template <typename T>
int launch_sweep(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* s_enter, const void* dy,
                 const void* ds_final, void* dx, void* ddt, void* da_part,
                 void* db_part, void* dc_part, int Bsz, int Lseq, int H,
                 int P, int N, int q, cudaStream_t st) {
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
  return (int)cudaGetLastError();
}

template <int NN>
int launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, const void* s_enter, const void* dy,
              const void* ds_final, void* dx, void* ddt, void* da_part,
              void* db_part, void* dc_part, int Bsz, int Lseq, int H, int P,
              int N, int q, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const size_t bytes = tc::Lay<NN>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      tc::ssd_bwd_tc_kernel<NN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return repro::refused(err);
  tc::ssd_bwd_tc_kernel<NN><<<dim3(H, Bsz), tc::NTH, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(s_enter),
      static_cast<const float*>(dy), static_cast<const float*>(ds_final),
      static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(da_part), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), Lseq, H, P, N, q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_head_sum(const void* db_part, const void* dc_part, void* db,
                    void* dc, const void* da_part, void* da, int Bsz,
                    int Lseq, int H, int N, int q, cudaStream_t st) {
  const long rows = (long)Bsz * Lseq;
  const int nbc = Bsz * ((Lseq + q - 1) / q);
  const int threads = 256;
  const long work = rows * N > H ? rows * N : H;
  const long blocks = (work + threads - 1) / threads;
  ssd_head_sum_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
      static_cast<T*>(db), static_cast<T*>(dc),
      static_cast<const float*>(da_part), static_cast<float*>(da), rows, H,
      N, nbc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm,
                            const void* s_enter, const void* dy,
                            const void* ds_final, void* dx, void* ddt,
                            void* da_part, void* da, void* db_part,
                            void* dc_part, void* db, void* dc, int Bsz,
                            int Lseq, int H, int P, int N, int q, int dtype,
                            void* stream) {
  if (repro::bad_ssd_shape(Bsz, Lseq, H, P, N, q))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == repro::DTYPE_F32) {
    err = launch_sweep<float>(x, dt, A, Bm, Cm, s_enter, dy, ds_final, dx,
                              ddt, da_part, db_part, dc_part, Bsz, Lseq, H,
                              P, N, q, st);
    if (err != 0) return err;
    return launch_head_sum<float>(db_part, dc_part, db, dc, da_part, da, Bsz,
                                  Lseq, H, N, q, st);
  }
  if (!tc_body(P, N, q))
    err = launch_sweep<__nv_bfloat16>(x, dt, A, Bm, Cm, s_enter, dy,
                                      ds_final, dx, ddt, da_part, db_part,
                                      dc_part, Bsz, Lseq, H, P, N, q, st);
  else if (N <= 64)
    err = launch_tc<64>(x, dt, A, Bm, Cm, s_enter, dy, ds_final, dx, ddt,
                        da_part, db_part, dc_part, Bsz, Lseq, H, P, N, q, st);
  else
    err = launch_tc<128>(x, dt, A, Bm, Cm, s_enter, dy, ds_final, dx, ddt,
                         da_part, db_part, dc_part, Bsz, Lseq, H, P, N, q,
                         st);
  if (err != 0) return err;
  return launch_head_sum<__nv_bfloat16>(db_part, dc_part, db, dc, da_part,
                                        da, Bsz, Lseq, H, N, q, st);
}
