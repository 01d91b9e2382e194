// The fused GIPO / entropy / k3-KL loss for Hopper, at two fusion levels:
// K4 (action head + loss, forward and backward) and K5 (the loss over given
// logits, forward and backward). Both share the per-row terms below
// (`row_terms`, `row_partials`, `row_g`, `dlogit`), as the reference's
// kernels share `_fwd_partials` and `_block_dlogits`.
//
// ---- K4 -------------------------------------------------------------------
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
//
// ---- K5 -------------------------------------------------------------------
// Replaces `_gipo_fwd_kernel` and `_gipo_bwd_kernel` behind the reference's
// `gipo_head_loss` (src/repro/kernels/gipo_loss.py). logits [N,V] (f32 or
// bf16, any N, V >= 1), the row operands as K4's.
//   forward:  per row, one walk over the logits keeping a running max m,
//             S = sum e^{s-m} and U = sum e^{s-m} (s-m) (both rescaled, U
//             with its own shift term, when m grows), merged across the
//             warp; then lse = log S, entropy H = lse - U / S, the target's
//             shifted logit (0 when the target is outside [0, V): the
//             reference's one-hot matches nothing) and the row terms -> the
//             8 columns, summed over the CTA's rows in a fixed order.
//   backward: the same walk, then a second one writing
//             d = g (onehot - p) + c_ent m (-p (log p + H)) in the logits'
//             dtype; rows with mask 0 write zeros.
// What bounds it: bytes. The forward reads the logits once; the backward
// reads them and writes d_logits (its second walk reads the row again, from
// L1/L2). At N = 16384, V = 256 f32 that is 16.8 MB, ~5 us forward.
// Design: one warp a row, 8 rows a CTA, 16-byte loads and stores; a row's
// unaligned head and its tail past the last whole vector take one element a
// lane, so any V and any row offset work (the wrapper gives d_logits the
// logits' offset within 16 bytes, so a row's head is the same for both).
// Nothing is accumulated across CTAs: each writes its own partial row or
// its own rows of d_logits, and reruns agree bit for bit.

#include "common.cuh"

namespace {

constexpr int BN = 16;          // token rows per CTA
constexpr int NT = 256;         // threads per CTA (8 warps)
constexpr int MAX_V = 256;      // a row's logits fit the CTA
constexpr int LSTR = MAX_V + 4; // shared row stride of the logits tile
constexpr int MMA_KT = 32;      // k step of the tensor-core body
constexpr int FMA_KT = 16;      // k step of the FMA body

// ---- per-row GIPO terms shared by K4 and K5 --------------------------------

struct RowTerms {
  float lr, ratio, omega, pg;
};

// log-ratio, ratio, trust weight w (eq. 5, constant) and surrogate -w r A
// (eq. 6) of a row, from its target's log-prob
__device__ __forceinline__ RowTerms row_terms(float logp_new, float logp_old,
                                              float adv, float sigma) {
  RowTerms r;
  r.lr = logp_new - logp_old;
  r.ratio = expf(r.lr);
  const float z = r.lr / sigma;
  r.omega = expf(-0.5f * (z * z));
  r.pg = -(r.omega * r.ratio * adv);
  return r;
}

// the row's 8 partial-sum columns (N_COLS in kernels/gipo_loss.py)
__device__ __forceinline__ void row_partials(float* out, const RowTerms& r,
                                             float ent, float m,
                                             float sigma) {
  out[0] = r.pg * m;
  out[1] = r.ratio * m;
  out[2] = r.omega * m;
  out[3] = m;
  out[4] = ent * m;
  out[5] = (expm1f(-r.lr) + r.lr) * m;
  out[6] = (fabsf(r.lr) > 2.f * sigma ? 1.f : 0.f) * m;
  out[7] = 0.f;
}

// the row's coefficient of (onehot - p): d pg / d logp_new and d k3 / d
// logp_new, weighted by the coefficient row c = (c_pg, c_kl, c_ent)
__device__ __forceinline__ float row_g(const RowTerms& r, const float* c,
                                       float m) {
  return (c[0] * r.pg + c[1] * (1.f - expf(-r.lr))) * m;
}

// one element of _block_dlogits: sh = s - max, se = sum e^{sh}
__device__ __forceinline__ float dlogit(float sh, float lse, float ent,
                                        float se, bool is_tgt, float g,
                                        float ce) {
  const float p = expf(sh) / se;
  return g * ((is_tgt ? 1.f : 0.f) - p) + ce * (-(p * ((sh - lse) + ent)));
}

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
    const float m = valid ? mask[n] : 0.f;
    const RowTerms t = row_terms(ts - lse, valid ? logp_old[n] : 0.f,
                                 valid ? adv[n] : 0.f, sigma);
    if constexpr (!BWD) {
      if (lane == 0) row_partials(rowv[r], t, ent, m, sigma);
    } else {
      const float g = row_g(t, coefs, m);
      const float ce = coefs[2] * m;
      for (int c = lane; c < V; c += 32) {
        const float d = dlogit(L[c] - mx, lse, ent, se, c == tgt, g, ce);
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


// ---- K5: the loss over given logits ----------------------------------------

constexpr int HEAD_ROWS = 8;   // token rows per CTA, one warp a row

// Running (max, sum e^{s-m}, sum e^{s-m} (s-m)) of one lane's elements.
struct RowStats {
  float m, S, U;
};

template <int W>
__device__ __forceinline__ void stats_push(RowStats& st, const float (&x)[W]) {
  float cm = x[0];
#pragma unroll
  for (int i = 1; i < W; ++i) cm = fmaxf(cm, x[i]);
  if (cm > st.m) {   // rescale both sums to the new max
    const float f = expf(st.m - cm);
    st.U = f * (st.U + (st.m - cm) * st.S);
    st.S *= f;
    st.m = cm;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float sh = x[i] - st.m;
    const float e = expf(sh);
    st.S += e;
    st.U += e * sh;
  }
}

// Symmetric in its arguments, so every lane of the butterfly ends with the
// same bits. An empty lane (m = NEG_INF, S = U = 0) adds exact zeros.
__device__ __forceinline__ RowStats stats_merge(const RowStats& a,
                                                const RowStats& b) {
  const float m = fmaxf(a.m, b.m);
  const float fa = expf(a.m - m), fb = expf(b.m - m);
  return {m, fa * a.S + fb * b.S,
          fa * (a.U + (a.m - m) * a.S) + fb * (b.U + (b.m - m) * b.S)};
}

__device__ __forceinline__ RowStats warp_merge(RowStats st) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const RowStats o{__shfl_xor_sync(0xffffffffu, st.m, off),
                     __shfl_xor_sync(0xffffffffu, st.S, off),
                     __shfl_xor_sync(0xffffffffu, st.U, off)};
    st = stats_merge(st, o);
  }
  return st;
}

__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[8]) {
  repro::load8(p, f);
}

template <typename T, int W>
__device__ __forceinline__ void store_elems(T* p, const float (&f)[W]) {
  if constexpr (W == 1) {
    *p = repro::from_f<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint4 u;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(f[2 * i],
                                                              f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// Calls fn(c, x) for a lane's share of row[0, V): x holds elements c.. as
// f32, one of them in the row's unaligned head and past its last whole
// 16-byte vector, W = 16 / sizeof(T) in between.
template <typename T, typename F>
__device__ __forceinline__ void walk_row(const T* row, int V, int lane,
                                         F&& fn) {
  constexpr int W = 16 / sizeof(T);
  const int head = min(
      V, (int)(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15)
               / sizeof(T)));
  const int tail = head + (V - head) / W * W;
  for (int c = lane; c < head; c += 32) {
    const float x[1] = {repro::to_f(row[c])};
    fn(c, x);
  }
  for (int c = head + lane * W; c < tail; c += 32 * W) {
    float x[W];
    load_vec(row + c, x);
    fn(c, x);
  }
  for (int c = tail + lane; c < V; c += 32) {
    const float x[1] = {repro::to_f(row[c])};
    fn(c, x);
  }
}

// Forward (BWD = false): per-CTA partial sums. Backward (BWD = true):
// d_logits, whose rows share the logits' offset within 16 bytes.
template <typename T, bool BWD>
__global__ void __launch_bounds__(HEAD_ROWS * 32)
gipo_head_kernel(const T* __restrict__ logits,
                 const int* __restrict__ targets,
                 const float* __restrict__ logp_old,
                 const float* __restrict__ adv,
                 const float* __restrict__ mask,
                 const float* __restrict__ coefs,
                 float* __restrict__ partials, T* __restrict__ dlogits,
                 int N, int V, float sigma) {
  __shared__ float rowv[HEAD_ROWS][8];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * HEAD_ROWS + warp;
  if (n < N) {
    const T* row = logits + (long)n * V;
    RowStats st{repro::NEG_INF, 0.f, 0.f};
    walk_row(row, V, lane, [&](int, const auto& x) { stats_push(st, x); });
    st = warp_merge(st);
    const float lse = logf(st.S);
    const float ent = lse - st.U / st.S;
    const int tgt = targets[n];
    const float ts = (tgt >= 0 && tgt < V) ? repro::to_f(row[tgt]) - st.m
                                           : 0.f;
    const float m = mask[n];
    const RowTerms t = row_terms(ts - lse, logp_old[n], adv[n], sigma);
    if constexpr (!BWD) {
      if (lane == 0) row_partials(rowv[warp], t, ent, m, sigma);
    } else {
      T* drow = dlogits + (long)n * V;
      const float g = row_g(t, coefs, m);
      const float ce = coefs[2] * m;
      walk_row(row, V, lane, [&](int c, const auto& x) {
        constexpr int W = sizeof(x) / sizeof(float);
        float o[W];
#pragma unroll
        for (int i = 0; i < W; ++i)
          o[i] = m == 0.f ? 0.f
                          : dlogit(x[i] - st.m, lse, ent, st.S, c + i == tgt,
                                   g, ce);
        store_elems<T, W>(drow + c, o);
      });
    }
  } else if constexpr (!BWD) {
    if (lane < 8) rowv[warp][lane] = 0.f;
  }
  if constexpr (!BWD) {
    __syncthreads();
    if (threadIdx.x < 8) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < HEAD_ROWS; ++r) s += rowv[r][threadIdx.x];
      partials[blockIdx.x * 8 + threadIdx.x] = s;
    }
  }
}

template <bool BWD>
int launch_head(const void* logits, const void* targets, const void* logp_old,
                const void* adv, const void* mask, const void* coefs,
                void* partials, void* dlogits, int N, int V, int dtype,
                float sigma, cudaStream_t st) {
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const int nb = (N + HEAD_ROWS - 1) / HEAD_ROWS;
#define REPRO_HEAD(T)                                                       \
  gipo_head_kernel<T, BWD><<<nb, HEAD_ROWS * 32, 0, st>>>(                  \
      static_cast<const T*>(logits), static_cast<const int*>(targets),      \
      static_cast<const float*>(logp_old), static_cast<const float*>(adv),  \
      static_cast<const float*>(mask), static_cast<const float*>(coefs),    \
      static_cast<float*>(partials), static_cast<T*>(dlogits), N, V, sigma)
  if (dtype == repro::DTYPE_F32) {
    REPRO_HEAD(float);
  } else if (dtype == repro::DTYPE_BF16) {
    REPRO_HEAD(__nv_bfloat16);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef REPRO_HEAD
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gipo_head_fwd(const void* logits, const void* targets,
                             const void* logp_old, const void* adv,
                             const void* mask, void* partials, int N, int V,
                             int dtype, float sigma, void* stream) {
  return launch_head<false>(logits, targets, logp_old, adv, mask, nullptr,
                            partials, nullptr, N, V, dtype, sigma,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int gipo_head_bwd(const void* logits, const void* targets,
                             const void* logp_old, const void* adv,
                             const void* mask, const void* coefs,
                             void* dlogits, int N, int V, int dtype,
                             float sigma, void* stream) {
  if ((reinterpret_cast<uintptr_t>(logits) ^
       reinterpret_cast<uintptr_t>(dlogits)) & 15)
    return (int)cudaErrorMisalignedAddress;
  return launch_head<true>(logits, targets, logp_old, adv, mask, coefs,
                           nullptr, dlogits, N, V, dtype, sigma,
                           static_cast<cudaStream_t>(stream));
}

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
