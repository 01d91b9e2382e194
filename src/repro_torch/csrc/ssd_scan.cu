// Chunked Mamba2 SSD scan, forward (K6), for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
// `_ssd_kernel` behind `ssd_scan`. x [B,L,H,P] (f32 or bf16), dt [B,L,H] f32
// (post-softplus), A [H] f32 (negative), Bm / Cm [B,L,N] (x's dtype, one
// group shared by the heads). Per chunk of q steps, with cum the inclusive
// cumsum of dt * A over the chunk and ct its last value:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//         + exp(cum_i) C_i . S^T                                   (inter)
//   S    <- exp(ct) S + sum_j exp(ct - cum_j) dt_j x_j B_j^T        (carry)
// y is written in f32, the final state S [B,H,P,N] in f32, and, when asked,
// every chunk's ENTERING state [B,NC,H,P,N] f32 (the residual K7 replays).
// L need not be a multiple of q: the last chunk's missing rows are loaded
// as zeros (dt = 0, x = B = C = 0), which leave cum, S and every valid y
// unchanged (exp(0) = 1 and the rows add nothing), and are not written.
//
// What bounds it on the H100, at the serving shape (B8 L256 H80 P64 N128,
// bf16): it reads x, B, C, dt once (~21 MB) and writes y and the final state
// (~63 MB), ~0.026 ms at 3.35 TB/s; its products are ~9.4 GFLOP, which the
// f32 FMA body below runs far from the tensor cores' rate, so this kernel is
// compute-bound in practice and many times its bound.
//
// Design. One CTA of 256 threads per (head, batch row) walks the chunks in
// order, as the TPU's sequential last grid axis did; the state S [P,N] f32
// lives in shared memory across chunks. Shared memory cannot hold the TPU's
// f32 tiles (x, B, C, S and the [q,q] matrix W are 256 KB at q = 128,
// N = 128, P = 64), so x, B and C stay in their storage dtype and
// W = (C.B^T) o G o dt is built RB = 32 rows at a time and applied to x
// before the next rows are built. Every product is an f32 FMA. G is taken
// only under the causal mask: for j > i the exponent is positive and could
// overflow, and inf * 0 is NaN. Row strides in shared memory carry one
// extra 16-byte unit, so neighbouring threads that read neighbouring rows
// hit different banks. Each output element is written by one thread; no
// atomics.

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA
constexpr int RB = 32;   // rows of W built and applied at a time

struct FwdLayout {
  int xs, bs, fs, ws;  // row strides (elements) of x, B/C, S, W
  size_t off_s, off_w, off_vec, off_x, off_b, off_c, bytes;
};

template <typename T>
__host__ __device__ FwdLayout fwd_layout(int q, int P, int N) {
  FwdLayout L;
  L.xs = P + 16 / (int)sizeof(T);
  L.bs = N + 16 / (int)sizeof(T);
  L.fs = N + 4;
  L.ws = q + 4;
  size_t o = 0;
  L.off_s = o;   o += (size_t)P * L.fs * 4;
  L.off_w = o;   o += (size_t)RB * L.ws * 4;
  L.off_vec = o; o += (size_t)4 * q * 4;        // cum, dt, din, ecum
  L.off_x = o;   o += (size_t)q * L.xs * sizeof(T);
  L.off_b = o;   o += (size_t)q * L.bs * sizeof(T);
  L.off_c = o;   o += (size_t)q * L.bs * sizeof(T);
  L.bytes = o;
  return L;
}

using repro::load8;
using repro::to_f;

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ s_final, float* __restrict__ s_enter,
               int Lseq, int H, int P, int N, int q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout Lo = fwd_layout<T>(q, P, N);
  float* S = reinterpret_cast<float*>(smem + Lo.off_s);
  float* W = reinterpret_cast<float*>(smem + Lo.off_w);
  float* cum = reinterpret_cast<float*>(smem + Lo.off_vec);
  float* dtv = cum + q;
  float* din = dtv + q;
  float* ecum = din + q;
  T* Xs = reinterpret_cast<T*>(smem + Lo.off_x);
  T* Bs = reinterpret_cast<T*>(smem + Lo.off_b);
  T* Cs = reinterpret_cast<T*>(smem + Lo.off_c);
  const int xs = Lo.xs, bs = Lo.bs, fs = Lo.fs, ws = Lo.ws;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nc = (Lseq + q - 1) / q;
  const float a = A[h];

  for (int idx = tid; idx < P * N; idx += NT)
    S[(idx / N) * fs + idx % N] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long t0 = (long)c * q;
    const int rows = min(q, Lseq - (int)t0);  // < q in a short last chunk
    __syncthreads();  // the previous chunk is done with every tile
    repro::load_tile(Xs, xs, x + ((b * (long)Lseq + t0) * H + h) * P,
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
      din[j] = expf(ct - cum[j]) * dtv[j];
      ecum[j] = expf(cum[j]);
    }
    __syncthreads();

    for (int r0b = 0; r0b < rows; r0b += RB) {
      // --- W rows [r0b, r0b + RB): (C_i . B_j) G_ij dt_j, j <= i ------------
      // a thread takes a row pair and the 8 columns cg + ncg * k, so that
      // neighbouring threads read neighbouring rows of B
      const int ncg = q / 8;
      for (int tile = tid; tile < (RB / 2) * ncg; tile += NT) {
        const int cg = tile % ncg, rp = tile / ncg;
        const int r0 = 2 * rp, i0 = r0b + r0;
        int kmax = 0;
        while (kmax < 8 && cg + ncg * kmax <= i0 + 1) ++kmax;
        float acc[2][8];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[0][k] = acc[1][k] = 0.f;
        if (kmax > 0) {
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
                  acc[0][k] = fmaf(c0[e], bv[e], acc[0][k]);
                  acc[1][k] = fmaf(c1[e], bv[e], acc[1][k]);
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
            // mask first: exp only of cum_i - cum_j <= 0
            W[(r0 + s) * ws + j] =
                j <= i ? acc[s][k] * expf(cum[i] - cum[j]) * dtv[j] : 0.f;
          }
        }
      }
      __syncthreads();

      // --- y rows [r0b, r0b + RB): W . x + exp(cum_i) C_i . S^T -----------
      // a thread takes a row pair and the 4 columns pg + npg * k
      const int npg = P / 4;
      for (int tile = tid; tile < (RB / 2) * npg; tile += NT) {
        const int pg = tile % npg, rp = tile / npg;
        const int r0 = 2 * rp, i0 = r0b + r0;
        float acc[2][4], cs[2][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[0][k] = acc[1][k] = cs[0][k] = cs[1][k] = 0.f;
        for (int j = 0; j <= i0 + 1; ++j) {
          const float w0 = W[r0 * ws + j], w1 = W[(r0 + 1) * ws + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float xv = to_f(Xs[(size_t)j * xs + pg + npg * k]);
            acc[0][k] = fmaf(w0, xv, acc[0][k]);
            acc[1][k] = fmaf(w1, xv, acc[1][k]);
          }
        }
        for (int n = 0; n < N; n += 8) {
          float c0[8], c1[8];
          load8(Cs + (size_t)i0 * bs + n, c0);
          load8(Cs + (size_t)(i0 + 1) * bs + n, c1);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float sv[8];
            load8(S + (size_t)(pg + npg * k) * fs + n, sv);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              cs[0][k] = fmaf(c0[e], sv[e], cs[0][k]);
              cs[1][k] = fmaf(c1[e], sv[e], cs[1][k]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int i = i0 + s;
          if (i >= rows) break;
          float* yrow = y + ((b * (long)Lseq + t0 + i) * H + h) * P;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            yrow[pg + npg * k] = acc[s][k] + ecum[i] * cs[s][k];
        }
      }
      __syncthreads();
    }

    // --- S <- exp(ct) S + sum_j din_j x_j B_j^T (entering state saved first)
    const float ect = expf(ct);
    const int nng = N / 8;
    for (int tile = tid; tile < (P / 4) * nng; tile += NT) {
      const int ng = tile % nng, pg = tile / nng;
      const int p0 = 4 * pg, n0 = 8 * ng;
      float sv[4][8], acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        load8(S + (size_t)(p0 + r) * fs + n0, sv[r]);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
      }
      if (s_enter != nullptr) {
        float* dst = s_enter + (((b * (long)nc + c) * H + h) * P + p0) * N
                     + n0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reinterpret_cast<float4*>(dst + (size_t)r * N)[0] =
              make_float4(sv[r][0], sv[r][1], sv[r][2], sv[r][3]);
          reinterpret_cast<float4*>(dst + (size_t)r * N)[1] =
              make_float4(sv[r][4], sv[r][5], sv[r][6], sv[r][7]);
        }
      }
      for (int j = 0; j < rows; ++j) {
        float bv[8];
        load8(Bs + (size_t)j * bs + n0, bv);
        const float d = din[j];
        float xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          xv[r] = to_f(Xs[(size_t)j * xs + p0 + r]) * d;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(xv[r], bv[e], acc[r][e]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          S[(size_t)(p0 + r) * fs + n0 + e] = ect * sv[r][e] + acc[r][e];
    }
  }
  __syncthreads();
  float* dst = s_final + ((long)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += NT)
    dst[idx] = S[(idx / N) * fs + idx % N];
}

template <typename T>
int launch_fwd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* s_final, void* s_enter, int Bsz,
               int Lseq, int H, int P, int N, int q, cudaStream_t st) {
  const size_t bytes = fwd_layout<T>(q, P, N).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return repro::refused(err);
  ssd_fwd_kernel<T><<<dim3(H, Bsz), NT, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(s_final), static_cast<float*>(s_enter), Lseq, H, P,
      N, q);
  return (int)cudaGetLastError();
}

}  // namespace

// s_enter may be null (no entering states written).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* s_final, void* s_enter, int Bsz, int Lseq,
                            int H, int P, int N, int q, int dtype,
                            void* stream) {
  if (repro::bad_ssd_shape(Bsz, Lseq, H, P, N, q))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return launch_fwd<float>(x, dt, A, Bm, Cm, y, s_final, s_enter, Bsz, Lseq,
                             H, P, N, q, st);
  return launch_fwd<__nv_bfloat16>(x, dt, A, Bm, Cm, y, s_final, s_enter, Bsz,
                                   Lseq, H, P, N, q, st);
}
