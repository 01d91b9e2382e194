// Fused action head + GIPO / entropy / k3-KL loss (K4), forward and
// backward, for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gipo_loss.py:
// `_policy_fwd_kernel` and `_policy_bwd_kernel` behind `fused_policy_loss`.
// hidden [N,d] (f32 or bf16), w [d,Va] (same dtype), targets i32 [N],
// logp_old / adv / mask f32 [N].
//   forward:  per block of BN token rows, logits = hidden . w in f32, row
//             log-softmax, target gather, trust weight w (eq. 5, constant),
//             surrogate (eq. 6), entropy, k3-KL, stale flag -> one row of the
//             8 partial-sum columns (N_COLS in kernels/gipo_loss.py).
//   backward: the block's logits again, then d = _block_dlogits(...) with the
//             coefficient row (c_pg, c_kl, c_ent); dh = d . w^T in hidden's
//             dtype; dw = sum_n h^T . d in f32.
// Rows >= N take mask 0 and are never stored (the reference's
// `_zero_mask_pad`); nothing is padded on the host.
//
// What bounds it on the H100, at the training slice's shapes (d = 4096,
// Va = 256, bf16): the forward reads hidden and w once (N = 224: 3.9 MB,
// ~1.2 us at 3.35 TB/s, against 0.47 GFLOP, ~0.5 us at 989 TFLOP/s), so it
// is memory-bound; the backward does three products of that size and reads
// hidden, w and writes dh, so it too is memory-bound at N = 224 and close to
// balanced at N = 3584.
//
// Design. One CTA of 256 threads per BN = 16 token rows; a row's Va <= 256
// logits stay in shared memory, so no [N, Va] tensor is written by the
// forward. bf16 with d % 32 == 0 and Va % 64 == 0 (the main path) forms the
// logits on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate;
// each of the 8 warps owns Va / 8 columns of the 16-row tile, w's fragments
// come transposed through ldmatrix as V's do in flash_attention.cu, and the
// next k step's tiles are loaded into registers while this one's products
// run); f32,
// and other bf16 widths, use f32 FMAs. The row math is one warp per row.
// In the backward, d stays f32 and both products run as f32 FMAs (d is not
// rounded to bf16 for the tensor cores, as the reference keeps it f32).
// The TPU accumulated dw across its sequential grid; CUDA CTAs run in
// parallel, so the backward is two kernels: the row kernel writes dh and d
// (f32 [N, Va], 1/8 of hidden's bytes at d = 4096), then a column kernel
// tiles dw 64 x 64 and loops over all N inside the CTA. No atomics: every
// output element is summed by one thread in a fixed order, so two runs
// agree bit for bit. Tensor-core dh / dw, and a split over d so that small
// N fills the card, are later work.

#include "common.cuh"

namespace {

constexpr int BN = 16;          // token rows per CTA
constexpr int NT = 256;         // threads per CTA (8 warps)
constexpr int MAX_V = 256;      // a row's logits fit the CTA
constexpr int LSTR = MAX_V + 4; // shared row stride of the logits tile
constexpr int MMA_KT = 32;      // k step of the tensor-core body
constexpr int FMA_KT = 16;      // k step of the FMA body

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// logits of rows [n0, n0 + BN) into Ls[BN][LSTR], tensor-core body.
// NT8 = n8 tiles per warp = Va / 64.
template <int NT8>
__device__ void block_logits_mma(const __nv_bfloat16* __restrict__ h,
                                 const __nv_bfloat16* __restrict__ w,
                                 float* Ls, int n0, int N, int D, int V) {
  constexpr int HS = MMA_KT + 8;     // padded rows: conflict-free fragments
  const int WS = V + 8;
  __shared__ __align__(16) __nv_bfloat16 Hs[BN * HS];
  __shared__ __align__(16) __nv_bfloat16 Ws[MMA_KT * (MAX_V + 8)];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col0 = warp * NT8 * 8;
  float acc[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // the next k step's tiles are loaded into registers while this one's
  // products run
  constexpr int W_LOADS = MMA_KT * (MAX_V / 8) / NT;
  const int hr = tid / (MMA_KT / 8), hc = (tid % (MMA_KT / 8)) * 8;
  uint4 hreg = make_uint4(0u, 0u, 0u, 0u);
  uint4 wreg[W_LOADS];
  auto fetch = [&](int k0) {
    if (tid < BN * MMA_KT / 8 && n0 + hr < N)
      hreg = *reinterpret_cast<const uint4*>(h + (long)(n0 + hr) * D + k0 +
                                             hc);
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = tid + i * NT;
      if (idx < MMA_KT * (V / 8))
        wreg[i] = *reinterpret_cast<const uint4*>(
            w + (long)(k0 + idx / (V / 8)) * V + (idx % (V / 8)) * 8);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < D; k0 += MMA_KT) {
    if (tid < BN * MMA_KT / 8)
      *reinterpret_cast<uint4*>(&Hs[hr * HS + hc]) = hreg;
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = tid + i * NT;
      if (idx < MMA_KT * (V / 8))
        *reinterpret_cast<uint4*>(
            &Ws[(idx / (V / 8)) * WS + (idx % (V / 8)) * 8]) = wreg[i];
    }
    __syncthreads();
    if (k0 + MMA_KT < D) fetch(k0 + MMA_KT);
#pragma unroll
    for (int kk = 0; kk < MMA_KT / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = ld32(&Hs[g * HS + c]);
      a[1] = ld32(&Hs[(g + 8) * HS + c]);
      a[2] = ld32(&Hs[g * HS + c + 8]);
      a[3] = ld32(&Hs[(g + 8) * HS + c + 8]);
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1,
                          &Ws[(kk * 16 + lane % 16) * WS + col0 + n * 8]);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
    const int c = col0 + n * 8 + 2 * t;
    Ls[g * LSTR + c] = acc[n][0];
    Ls[g * LSTR + c + 1] = acc[n][1];
    Ls[(g + 8) * LSTR + c] = acc[n][2];
    Ls[(g + 8) * LSTR + c + 1] = acc[n][3];
  }
}

// logits of rows [n0, n0 + BN) into Ls, f32 FMA body (any d, Va <= 256).
// Warp w owns rows 2w and 2w + 1; lane owns columns lane + 32 j.
template <typename T>
__device__ void block_logits_fma(const T* __restrict__ h,
                                 const T* __restrict__ w, float* Ls, int n0,
                                 int N, int D, int V) {
  __shared__ float Hs[BN][FMA_KT];
  __shared__ float Ws[FMA_KT][MAX_V];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float acc[2][MAX_V / 32];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MAX_V / 32; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += FMA_KT) {
    {
      const int r = tid / FMA_KT, c = tid % FMA_KT;   // BN * FMA_KT == NT
      Hs[r][c] = (n0 + r < N && k0 + c < D)
                     ? repro::to_f(h[(long)(n0 + r) * D + k0 + c])
                     : 0.f;
    }
    for (int idx = tid; idx < FMA_KT * V; idx += NT) {
      const int r = idx / V, c = idx % V;
      Ws[r][c] = k0 + r < D ? repro::to_f(w[(long)(k0 + r) * V + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FMA_KT; ++kk) {
      const float h0 = Hs[2 * warp][kk], h1 = Hs[2 * warp + 1][kk];
#pragma unroll
      for (int j = 0; j < MAX_V / 32; ++j) {
        const int c = lane + 32 * j;
        const float wv = c < V ? Ws[kk][c] : 0.f;
        acc[0][j] = fmaf(h0, wv, acc[0][j]);
        acc[1][j] = fmaf(h1, wv, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < MAX_V / 32; ++j) {
    const int c = lane + 32 * j;
    if (c < V) {
      Ls[(2 * warp) * LSTR + c] = acc[0][j];
      Ls[(2 * warp + 1) * LSTR + c] = acc[1][j];
    }
  }
}

// Forward (BWD = false): per-block partial sums. Backward (BWD = true): d
// into Ls and dlogits, then dh. NT8 = 0 selects the FMA logits body.
template <typename T, int NT8, bool BWD>
__global__ void __launch_bounds__(NT)
policy_rows_kernel(const T* __restrict__ h, const T* __restrict__ w,
                   const int* __restrict__ targets,
                   const float* __restrict__ logp_old,
                   const float* __restrict__ adv,
                   const float* __restrict__ mask,
                   const float* __restrict__ coefs,
                   float* __restrict__ partials, T* __restrict__ dh,
                   float* __restrict__ dlogits, int N, int D, int V,
                   float sigma) {
  __shared__ __align__(16) float Ls[BN * LSTR];
  __shared__ float rowv[BN][8];
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if constexpr (NT8 > 0) {
    block_logits_mma<NT8>(h, w, Ls, n0, N, D, V);
  } else {
    block_logits_fma<T>(h, w, Ls, n0, N, D, V);
  }
  __syncthreads();

  // row math: warp w owns rows 2w and 2w + 1
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 2 * warp + rr;
    const int n = n0 + r;
    const bool valid = n < N;
    float* L = Ls + r * LSTR;
    float mx = -INFINITY;
    for (int c = lane; c < V; c += 32) mx = fmaxf(mx, L[c]);
    mx = repro::warp_max(mx);
    float se = 0.f;
    for (int c = lane; c < V; c += 32) se += expf(L[c] - mx);
    se = repro::warp_sum(se);
    const float lse = logf(se);
    const int tgt = valid ? targets[n] : -1;
    float ts = 0.f, plp = 0.f;
    for (int c = lane; c < V; c += 32) {
      const float sh = L[c] - mx;
      if (c == tgt) ts = sh;
      const float p = expf(sh) / se;
      plp += p * (sh - lse);
    }
    ts = repro::warp_sum(ts);
    const float ent = -repro::warp_sum(plp);
    const float logp_new = ts - lse;
    const float m = valid ? mask[n] : 0.f;
    const float lr = logp_new - (valid ? logp_old[n] : 0.f);
    const float a = valid ? adv[n] : 0.f;
    const float ratio = expf(lr);
    const float z = lr / sigma;
    const float omega = expf(-0.5f * (z * z));
    const float pg = -(omega * ratio * a);
    if constexpr (!BWD) {
      if (lane == 0) {
        rowv[r][0] = pg * m;
        rowv[r][1] = ratio * m;
        rowv[r][2] = omega * m;
        rowv[r][3] = m;
        rowv[r][4] = ent * m;
        rowv[r][5] = (expm1f(-lr) + lr) * m;
        rowv[r][6] = (fabsf(lr) > 2.f * sigma ? 1.f : 0.f) * m;
        rowv[r][7] = 0.f;
      }
    } else {
      const float g = (coefs[0] * pg + coefs[1] * (1.f - expf(-lr))) * m;
      const float ce = coefs[2] * m;
      for (int c = lane; c < V; c += 32) {
        const float sh = L[c] - mx;
        const float p = expf(sh) / se;
        const float d = g * ((c == tgt ? 1.f : 0.f) - p) +
                        ce * (-(p * ((sh - lse) + ent)));
        L[c] = d;
        if (valid) dlogits[(long)n * V + c] = d;
      }
    }
  }
  __syncthreads();

  if constexpr (!BWD) {
    if (tid < 8) {
      float s = 0.f;
      for (int r = 0; r < BN; ++r) s += rowv[r][tid];
      partials[blockIdx.x * 8 + tid] = s;
    }
  } else {
    // dh = d . w^T: thread owns columns j of d_model, all BN rows
    const int rows = min(BN, N - n0);
    for (int j = tid; j < D; j += NT) {
      float acc[BN];
#pragma unroll
      for (int r = 0; r < BN; ++r) acc[r] = 0.f;
      const T* wr = w + (long)j * V;
      for (int v0 = 0; v0 < V; v0 += 8) {
        float wv[8];
        repro::load8(wr + v0, wv);
#pragma unroll
        for (int r = 0; r < BN; ++r) {
          const float* dr = &Ls[r * LSTR + v0];
          const float4 d0 = *reinterpret_cast<const float4*>(dr);
          const float4 d1 = *reinterpret_cast<const float4*>(dr + 4);
          float s = acc[r];
          s = fmaf(d0.x, wv[0], s);
          s = fmaf(d0.y, wv[1], s);
          s = fmaf(d0.z, wv[2], s);
          s = fmaf(d0.w, wv[3], s);
          s = fmaf(d1.x, wv[4], s);
          s = fmaf(d1.y, wv[5], s);
          s = fmaf(d1.z, wv[6], s);
          s = fmaf(d1.w, wv[7], s);
          acc[r] = s;
        }
      }
#pragma unroll
      for (int r = 0; r < BN; ++r)
        if (r < rows) dh[(long)(n0 + r) * D + j] = repro::from_f<T>(acc[r]);
    }
  }
}

// dw [D, V] f32 = sum_n h[n]^T d[n]: one CTA per 64 x 64 tile of dw, looping
// over all N rows in a fixed order (no atomics).
constexpr int DW_T = 64;
constexpr int DW_K = 32;

template <typename T>
__global__ void __launch_bounds__(NT)
policy_dw_kernel(const T* __restrict__ h, const float* __restrict__ dlogits,
                 float* __restrict__ dw, int N, int D, int V) {
  __shared__ __align__(16) float Hs[DW_K][DW_T + 4];
  __shared__ __align__(16) float Ds[DW_K][DW_T + 4];
  const int j0 = blockIdx.x * DW_T, v0 = blockIdx.y * DW_T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  for (int n0 = 0; n0 < N; n0 += DW_K) {
    {   // DW_K x DW_T = 256 chunks of 8: one per thread, each operand
      const int r = tid / (DW_T / 8), c = (tid % (DW_T / 8)) * 8;
      float hf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float df[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (n0 + r < N) {
        if (j0 + c < D) repro::load8(h + (long)(n0 + r) * D + j0 + c, hf);
        if (v0 + c < V)
          repro::load8(dlogits + (long)(n0 + r) * V + v0 + c, df);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Hs[r][c + e] = hf[e];
        Ds[r][c + e] = df[e];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < DW_K; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Hs[r][ty + 16 * i];
#pragma unroll
      for (int k = 0; k < 4; ++k) b[k] = Ds[r][tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(a[i], b[k], acc[i][k]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + ty + 16 * i;
    if (j >= D) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = v0 + tx + 16 * k;
      if (v < V) dw[(long)j * V + v] = acc[i][k];
    }
  }
}

template <typename T, int NT8, bool BWD>
int launch_rows(const void* h, const void* w, const void* targets,
                const void* logp_old, const void* adv, const void* mask,
                const void* coefs, void* partials, void* dh, void* dlogits,
                int N, int D, int V, float sigma, cudaStream_t st) {
  const int nb = (N + BN - 1) / BN;
  policy_rows_kernel<T, NT8, BWD><<<nb, NT, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const int*>(targets), static_cast<const float*>(logp_old),
      static_cast<const float*>(adv), static_cast<const float*>(mask),
      static_cast<const float*>(coefs), static_cast<float*>(partials),
      static_cast<T*>(dh), static_cast<float*>(dlogits), N, D, V, sigma);
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch_rows(const void* h, const void* w, const void* targets,
                  const void* logp_old, const void* adv, const void* mask,
                  const void* coefs, void* partials, void* dh, void* dlogits,
                  int N, int D, int V, int dtype, float sigma,
                  cudaStream_t st) {
#define REPRO_ROWS(T, n)                                                    \
  launch_rows<T, n, BWD>(h, w, targets, logp_old, adv, mask, coefs,         \
                         partials, dh, dlogits, N, D, V, sigma, st)
  if (dtype == repro::DTYPE_F32) return REPRO_ROWS(float, 0);
  if (dtype != repro::DTYPE_BF16) return (int)cudaErrorInvalidValue;
  if (D % MMA_KT == 0 && V % 64 == 0) {
    switch (V / 64) {
      case 1: return REPRO_ROWS(__nv_bfloat16, 1);
      case 2: return REPRO_ROWS(__nv_bfloat16, 2);
      case 3: return REPRO_ROWS(__nv_bfloat16, 3);
      case 4: return REPRO_ROWS(__nv_bfloat16, 4);
    }
  }
  return REPRO_ROWS(__nv_bfloat16, 0);
#undef REPRO_ROWS
}

bool bad_shape(int N, int D, int V) {
  return N <= 0 || D <= 0 || D % 8 != 0 || V % 8 != 0 || V < 8 || V > MAX_V;
}

}  // namespace

extern "C" int policy_loss_fwd(const void* h, const void* w,
                               const void* targets, const void* logp_old,
                               const void* adv, const void* mask,
                               void* partials, int N, int D, int V, int dtype,
                               float sigma, void* stream) {
  if (bad_shape(N, D, V)) return (int)cudaErrorInvalidValue;
  return dispatch_rows<false>(h, w, targets, logp_old, adv, mask, nullptr,
                              partials, nullptr, nullptr, N, D, V, dtype,
                              sigma, static_cast<cudaStream_t>(stream));
}

extern "C" int policy_loss_bwd(const void* h, const void* w,
                               const void* targets, const void* logp_old,
                               const void* adv, const void* mask,
                               const void* coefs, void* dh, void* dlogits,
                               void* dw, int N, int D, int V, int dtype,
                               float sigma, void* stream) {
  if (bad_shape(N, D, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = dispatch_rows<true>(h, w, targets, logp_old, adv, mask, coefs,
                                nullptr, dh, dlogits, N, D, V, dtype, sigma,
                                st);
  if (err != 0) return err;
  const dim3 grid((D + DW_T - 1) / DW_T, (V + DW_T - 1) / DW_T);
  if (dtype == repro::DTYPE_F32)
    policy_dw_kernel<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(dlogits),
        static_cast<float*>(dw), N, D, V);
  else
    policy_dw_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const float*>(dlogits), static_cast<float*>(dw), N, D, V);
  return (int)cudaGetLastError();
}
