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
//   forward:  logits = hidden . w in f32, row log-softmax, target gather,
//             trust weight w (eq. 5, constant), surrogate (eq. 6), entropy,
//             k3-KL, stale flag -> rows of the 8 partial-sum columns (N_COLS
//             in kernels/gipo_loss.py), each a sum over a few token rows.
//   backward: the logits again, then d = _block_dlogits(...) with the
//             coefficient row (c_pg, c_kl, c_ent); dh = d . w^T in hidden's
//             dtype; dw = sum_n h^T . d in w's dtype (summed in f32 and
//             rounded once, as the reference).
// Rows >= N take mask 0 and are never stored (the reference's
// `_zero_mask_pad`); nothing is padded on the host.
//
// What bounds it on the H100, at the training slice's shapes (N = 224 rows,
// d = 4096, Va = 256, bf16): the forward reads hidden and w once (3.9 MB,
// ~1.2 us at 3.35 TB/s, against 0.47 GFLOP, ~0.5 us at 989 TFLOP/s), so it
// is memory-bound; the backward does three products of that size and reads
// hidden, w and writes dh, so it too is memory-bound at N = 224 and close to
// balanced at N = 3584. At N = 224 that is too little work for one CTA per
// block of rows (14 CTAs on 132 SMs): the work has to be split over d.
//
// Tensor-core body (bf16, any d). A cluster of CS CTAs (16 at d >= 256;
// non-portable above 8) takes a tile of TM = 32 token rows, rank r a slice
// of `slice` (d / CS rounded up to 16) rows of d: grid (CS, ceil(N / 32)),
// 112 CTAs at N = 224. TMA brings the rank's slice of w (Va <= 256 columns,
// 128 KB at d = 4096) and of the tile's hidden rows in groups of 64 rows of
// d (boxes with 128-byte swizzle, zeros past N, d and Va) into four slots,
// one mbarrier a slot, each group's products starting as it lands (past d
// 4096 the later groups stream through the slots as they free); the
// rank forms its partial f32 logits tile [32, Va] on the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 products exact, chained through the
// accumulators over the slice). Each rank sends row m of its tile to rank
// m / (32 / CS) through distributed shared memory; after a cluster barrier
// rank r sums the rows it received in rank order, and runs the row math
// (one warp a row); the forward writes one partial row per CTA. The
// backward keeps going in the same launch: each rank writes d for its rows
// (f32, to shared memory and to an [N, Va] scratch), sends them to every
// rank, and after a second barrier forms dh[rows, its slice] = d .
// w[slice]^T from the w slice still in shared memory (past d 4096, four
// groups at a time, reloading those the slots no longer hold), d in three
// bf16 terms (hi, mid, lo: ~24 bits, so every product is exact), the three
// products of a k16 step summed from zero and added in f32 (a chain through
// the accumulators would round toward zero at every step). A split over d
// needs no reduction for dh. Then dw = sum_n h^T . d is a second kernel,
// launched as the first one's dependent (programmatic dependent launch): a
// CTA takes 64 rows of dw x 64 columns of Va and walks all N rows in order,
// 64 at a time, through a TMA ring of three stages, hidden's rows
// transposed by ldmatrix.trans and d in three bf16 terms on the tensor
// cores (each k16 step from zero, added in f32), and writes dw in w's
// dtype. No atomics: every output element is summed by one thread in a
// fixed order, so two runs agree bit for bit. The order of arithmetic is
// kernels/ref.py::tiled_policy_loss with the rank's slice. What holds it back
// (PERF.md section 6): at N = 224 the launch, the two cluster barriers and
// the row math cost as much as the loads, and the three-term products of
// dh and dw run at about half of mma.sync's rate.
//
// FMA body (f32: the f32 witnesses). One CTA of 256 threads per BN = 16
// token rows; a row's Va <= 256 logits stay in shared memory. Logits, dh
// and dw as f32 FMAs; the row kernel writes dh and d (f32 [N, Va]), then a
// column kernel tiles dw 64 x 64 and loops over all N inside the CTA.
//
// ---- K5 -------------------------------------------------------------------
// Replaces `_gipo_fwd_kernel` and `_gipo_bwd_kernel` behind the reference's
// `gipo_head_loss` (src/repro/kernels/gipo_loss.py). logits [N,V] (f32 or
// bf16, any N, V >= 1), the row operands as K4's.
//   forward:  per row the max m, then S = sum e and U = sum e (s - m) with
//             e = e^{s-m}; lse = log S, entropy H = lse - U / S, the
//             target's shifted logit (0 when the target is outside [0, V):
//             the reference's one-hot matches nothing) and the row terms ->
//             the 8 columns, summed over a block of rows in a fixed order.
//   backward: d = g (onehot - p) + c_ent m (-p (log p + H)), p = e / S, in
//             the logits' dtype; rows with mask 0 write zeros.
// What bounds it: bytes. The forward reads the logits once (33.5 MB at
// N 65536, V 256 in bf16: 10 us at 3.35 TB/s); the backward reads them and
// writes d_logits (20 us). Next come the exponentials: the H100 SXM's MUFU
// does 16 a clock an SM (~3.7 T/s), 4.5 us for one an element at that
// shape, and the old backward's second expf and IEEE divide an element cost
// about as much again. So each element's exponential is taken once (base
// 2, as K1's softmax: ex2.approx of (s - m) log2 e, 5 instructions an
// element with the sums), and loads and math have to overlap.
// Register body (V <= HEAD_MAX_V = 1024, both dtypes): a row is split over
// `lanes` lanes (4 to 32; a warp takes 32 / lanes rows at once), lane j
// holding the row's 16-byte vectors j, j + lanes, ... (up to HEAD_VECS = 8
// of them: 32 f32 or 64 bf16 elements) and elements j, j + lanes, ... of
// the row's unaligned head (its elements before a 16-byte boundary, up to
// 7 in bf16) and of its tail past the last whole vector, so any V and any
// row offset work. The CTAs (4 warps) are persistent: thread 0
// bulk-copies (`hp::bulk_load`, one mbarrier a stage) each step's logits,
// the 16-byte chunks covering its rows, into a ring of HEAD_STAGES = 2
// stages, a step ahead of the warps (the next step's copy in flight while
// a step is computed, at most 33 KB of shared memory a CTA, so 6 CTAs fit
// an SM); the row operands come in a step ahead by plain loads; so every
// load is issued before the math that needs it, and no load waits on
// another (the target's logit is read from the stage). The copies read up
// to 15 bytes before and after the rows, within the 16-byte chunks that
// hold the first and last of them. A warp reads its rows from the stage
// into registers (a warp-wide test takes a path without predicates where
// every row is aligned and fills the lanes' vectors), then the max (a
// butterfly over the row's lanes), one pass forming e, S and U with e kept
// in registers, one butterfly for both sums, and the row terms. The forward writes one
// partial row a warp's rows, summed in row order through shuffles; the
// backward forms d from the kept e with one reciprocal a row (no second
// exponential, no divide an element), writes it with 16-byte streaming
// stores without the one-hot term, and the lane holding the target's
// element stores that element again with it (d_logits shares the logits'
// offset within 16 bytes, so a row's head is the same for both). The plan
// (`head_plan`) takes the fewest lanes whose vectors hold the row, or 32
// where that leaves fewer rows than 4 warps an SM, and 4 warps a CTA unless
// fewer cover the SMs: on the H100 SXM's 132, at N 224, V 256 one row a
// warp and one warp a CTA, 224 CTAs. The SM count and each plan's CTAs an
// SM are asked of the runtime once and kept. The order of arithmetic is
// kernels/ref.py::tiled_gipo_head_loss.
// What still holds it back (PERF.md section 6, scripts/time_gipo_head.py):
// the bf16 forward stays above twice its byte bound. The repo's L2 flush
// leaves the cache full of dirty lines, which the forward's reads must
// write back first (it runs ~17% faster after a flush that leaves the
// cache clean), and the math (5 instructions an element, and the row
// terms) no longer hides under the loads at half the bytes of f32.
// Streaming body (V > 1024): one warp a row, 8 rows a CTA, one walk over
// the logits keeping a running max and both sums (rescaled when the max
// grows), merged across the warp, then the target's logit, and in the
// backward a second walk; 16-byte loads and stores between a scalar head
// and tail.
// Nothing is accumulated across CTAs: each writes its own partial rows or
// its own rows of d_logits, and reruns agree bit for bit. The C entries
// choose the body; `gipo_head_lanes`, `gipo_head_block_rows` and
// `gipo_head_partial_rows` report the plan.

#include <atomic>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = repro::hopper;
using bf16 = __nv_bfloat16;

constexpr int BN = 16;          // token rows per CTA of the FMA body
constexpr int NT = 256;         // threads per CTA (8 warps)
constexpr int MAX_V = 256;      // a row's logits fit the CTA
constexpr int LSTR = MAX_V + 4; // shared row stride of the logits tile
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

// K4's row math, one warp on token row n, whose logits L[0, V) (f32) are in
// shared memory: log-softmax, the target's log-prob and the row terms, with
// the row's operands (target, logp_old, advantage, mask; -1, 0, 0, 0 past
// N). Forward: lane 0 writes the row's 8 partial columns to `out`.
// Backward: d over L in place, and into dlogits [N, V] if the row is valid.
template <bool BWD>
__device__ __forceinline__ void row_loss(float* L, int V, int n, int N,
                                         int tgt, float lo, float ad,
                                         float m, const float* coefs,
                                         float sigma, float* out,
                                         float* __restrict__ dlogits) {
  const int lane = threadIdx.x % 32;
  float mx = -INFINITY;
  for (int c = lane; c < V; c += 32) mx = fmaxf(mx, L[c]);
  mx = repro::warp_max(mx);
  float se = 0.f;
  for (int c = lane; c < V; c += 32) se += expf(L[c] - mx);
  se = repro::warp_sum(se);
  const float lse = logf(se);
  float ts = 0.f, plp = 0.f;
  for (int c = lane; c < V; c += 32) {
    const float sh = L[c] - mx;
    if (c == tgt) ts = sh;
    const float p = expf(sh) / se;
    plp += p * (sh - lse);
  }
  ts = repro::warp_sum(ts);
  const float ent = -repro::warp_sum(plp);
  const RowTerms t = row_terms(ts - lse, lo, ad, sigma);
  if constexpr (!BWD) {
    if (lane == 0) row_partials(out, t, ent, m, sigma);
  } else {
    const float g = row_g(t, coefs, m);
    const float ce = coefs[2] * m;
    for (int c = lane; c < V; c += 32) {
      const float d = dlogit(L[c] - mx, lse, ent, se, c == tgt, g, ce);
      L[c] = d;
      if (n < N) dlogits[(long)n * V + c] = d;
    }
  }
}

// ---- K4, FMA body -----------------------------------------------------------

// logits of rows [n0, n0 + BN) into Ls, f32 FMA body (any d, Va <= 256).
// Warp w owns rows 2w and 2w + 1; lane owns columns lane + 32 j.
__device__ void block_logits_fma(const float* __restrict__ h,
                                 const float* __restrict__ w, float* Ls,
                                 int n0, int N, int D, int V) {
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
                     ? h[(long)(n0 + r) * D + k0 + c]
                     : 0.f;
    }
    for (int idx = tid; idx < FMA_KT * V; idx += NT) {
      const int r = idx / V, c = idx % V;
      Ws[r][c] = k0 + r < D ? w[(long)(k0 + r) * V + c] : 0.f;
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
// into Ls and dlogits, then dh.
template <bool BWD>
__global__ void __launch_bounds__(NT)
policy_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const int* __restrict__ targets,
                   const float* __restrict__ logp_old,
                   const float* __restrict__ adv,
                   const float* __restrict__ mask,
                   const float* __restrict__ coefs,
                   float* __restrict__ partials, float* __restrict__ dh,
                   float* __restrict__ dlogits, int N, int D, int V,
                   float sigma) {
  __shared__ __align__(16) float Ls[BN * LSTR];
  __shared__ float rowv[BN][8];
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32;

  block_logits_fma(h, w, Ls, n0, N, D, V);
  __syncthreads();
  // row math: warp w owns rows 2w and 2w + 1
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 2 * warp + rr, n = n0 + r;
    const bool ok = n < N;
    row_loss<BWD>(Ls + r * LSTR, V, n, N, ok ? targets[n] : -1,
                  ok ? logp_old[n] : 0.f, ok ? adv[n] : 0.f,
                  ok ? mask[n] : 0.f, coefs, sigma, rowv[r], dlogits);
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
      const float* wr = w + (long)j * V;
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
        if (r < rows) dh[(long)(n0 + r) * D + j] = acc[r];
    }
  }
}

// dw [D, V] f32 = sum_n h[n]^T d[n], f32 inputs: one CTA per 64 x 64 tile
// of dw, looping over all N rows in a fixed order (no atomics).
constexpr int DW_T = 64;
constexpr int DW_K = 32;

__global__ void __launch_bounds__(NT)
policy_dw_kernel(const float* __restrict__ h,
                 const float* __restrict__ dlogits, float* __restrict__ dw,
                 int N, int D, int V) {
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

// ---- K4, tensor-core body ---------------------------------------------------

constexpr int TM = 32;            // token rows of a cluster's tile
constexpr int MAX_CLUSTER = 16;   // ranks along d
constexpr int KG = 64;            // d rows of one TMA box, and of a group
constexpr int SLOTS = 4;          // groups of w a rank holds at once
constexpr int WIN = SLOTS * KG;   // 256 d rows: the slice whole to d 4096

// How a (D, V) problem splits over a cluster, and a rank's shared memory
// (from a 1024-byte boundary). Rank r takes rows [r slice, (r + 1) slice)
// of d, `sp` = slice rounded up to ng groups of 64; group g lives in slot
// g % SLOTS, so a slice of up to 4 groups stays whole and a longer one
// streams through the slots. Per slot: w's rows x Va in column chunks of 64
// (chunk c at c * wr * 128; boxes of 64 x 64, 128-byte swizzle), and the
// tile's hidden columns [TM][64] (rows of d past the slice belong to the
// next rank and are never read); then the partial logits rows every rank
// sends this one [cs][rpr][PS] f32, this rank's rows of logits and then d
// [rpr][PS] f32, (backward) the tile's d gathered from every rank [TM][PS]
// f32, the rows' operands and partial columns, one mbarrier a slot.
struct ClusterPlan {
  int cs, slice, sp, ng, wr, vp, vc, rpr, ps;
  size_t o_h, o_r, o_l, o_d, o_op, o_bar, bytes;
};

__host__ __device__ inline ClusterPlan cluster_plan(int D, int V, bool bwd) {
  ClusterPlan p;
  p.cs = MAX_CLUSTER;
  while (p.cs > 1 && p.cs * 16 > D) p.cs /= 2;
  p.slice = ((D + p.cs - 1) / p.cs + 15) / 16 * 16;
  p.sp = (p.slice + KG - 1) / KG * KG;
  p.ng = p.sp / KG;
  p.wr = min(p.sp, WIN);
  p.vp = (V + 15) / 16 * 16;
  p.vc = (V + 63) / 64;
  p.rpr = TM / p.cs;
  p.ps = p.vp + 8;      // +32 bytes a row: float2 rows on distinct banks
  p.o_h = (size_t)p.vc * p.wr * 128;
  p.o_r = p.o_h + (size_t)p.wr / 64 * TM * 128;
  p.o_l = p.o_r + (size_t)TM * p.ps * 4;
  p.o_d = p.o_l + (size_t)p.rpr * p.ps * 4;
  p.o_op = p.o_d + (bwd ? (size_t)TM * p.ps * 4 : 0);
  p.o_bar = p.o_op + (size_t)p.rpr * 12 * 4;   // operands, partial columns
  p.bytes = p.o_bar + SLOTS * 8 + 1024;        // + alignment slack
  return p;
}

// Forward (BWD = false): one partial row per CTA. Backward (BWD = true): d
// into dlogits, then dh[tile rows, the rank's slice]. hmap: hidden [N, D],
// boxes of 32 x 64; wmap: w [D, V], boxes of 64 x 64.
template <bool BWD>
__global__ void __launch_bounds__(NT, 1)
policy_cluster_kernel(const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const int* __restrict__ targets,
                      const float* __restrict__ logp_old,
                      const float* __restrict__ adv,
                      const float* __restrict__ mask,
                      const float* __restrict__ coefs,
                      float* __restrict__ partials, bf16* __restrict__ dh,
                      float* __restrict__ dlogits, int N, int D, int V,
                      float sigma) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = hp::align1024(smem_raw);
  const ClusterPlan pl = cluster_plan(D, V, BWD);
  uint8_t* Ws = smem;
  uint8_t* Hs = smem + pl.o_h;
  float* Rv = reinterpret_cast<float*>(smem + pl.o_r);
  float* Lr = reinterpret_cast<float*>(smem + pl.o_l);
  float* Dt = reinterpret_cast<float*>(smem + pl.o_d);
  float* rowop = reinterpret_cast<float*>(smem + pl.o_op);
  float* rowv = rowop + pl.rpr * 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + pl.o_bar);
  const int cs = pl.cs, slice = pl.slice, vp = pl.vp;
  const int rpr = pl.rpr, PS = pl.ps;
  const int rank = blockIdx.x, tile = blockIdx.y;
  const int n0 = tile * TM, k0 = rank * slice, rb = rank * rpr;
  const int kn = max(0, min(slice, D - k0));   // the slice's rows inside d
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mh = warp & 1, q = warp >> 1;     // 16-row half, column quarter
  const int ng = pl.ng, wr = pl.wr;
  const hp::Lane ln(lane);
  hp::cluster_arrive_relaxed();

  // group gr of w's slice (Va / 64 boxes) and, `with_h`, of the tile's
  // hidden columns (one box) into slot gr % SLOTS (thread 0)
  auto issue = [&](int gr, bool with_h) {
    const int sl = gr % SLOTS;
    hp::bar_expect(&bars[sl], pl.vc * KG * 128 + (with_h ? TM * 128 : 0));
    for (int c = 0; c < pl.vc; ++c)
      hp::tma_load_2d(Ws + (size_t)c * wr * 128 + sl * KG * 128, &wmap,
                      &bars[sl], c * 64, k0 + gr * KG);
    if (with_h)
      hp::tma_load_2d(Hs + sl * TM * 128, &hmap, &bars[sl], k0 + gr * KG,
                      n0);
  };
  if (tid == 0) {
    for (int sl = 0; sl < SLOTS; ++sl) hp::bar_init(&bars[sl], 1);
    hp::bar_init_fence();
    for (int gr = 0; gr < min(ng, SLOTS); ++gr) issue(gr, true);
  }
  // the operands of this rank's rows, loaded while the tiles arrive
  if (tid < rpr) {
    const int n = n0 + rb + tid;
    const bool ok = n < N;
    rowop[4 * tid] = __int_as_float(ok ? targets[n] : -1);
    rowop[4 * tid + 1] = ok ? logp_old[n] : 0.f;
    rowop[4 * tid + 2] = ok ? adv[n] : 0.f;
    rowop[4 * tid + 3] = ok ? mask[n] : 0.f;
  }
  __syncthreads();                    // the barriers are initialised
  if constexpr (BWD) hp::griddep_launch_dependents();

  // the partial logits tile: warp (mh, q) takes rows 16 mh.. and the column
  // pairs (16 columns) q, q + 4, q + 8, q + 12. The products are exact, and
  // the rank's k16 steps chain through the accumulators on the tensor cores
  // (PERF.md section 6 holds this order against per-step and per-group
  // sums added in f32). Lane addresses: a row's 16-byte unit u sits at
  // u ^ (row % 8), and every k step starts on a multiple of 16 rows, so the
  // XOR is the lane's own. A group past the first SLOTS takes the slot of
  // group gi - SLOTS once every warp is done with it.
  const int np = vp / 16;
  const int ar = 16 * mh + ln.a_r, ax = ar & 7, bx = ln.bt_k & 7;
  const uint8_t* wb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 16 * (q + 4 * i) + ln.bt_n;
    wb[i] = Ws + (col >> 6) * wr * 128 + ((((col >> 3) & 7) ^ bx) << 4) +
            ln.bt_k * 128;
  }
  float acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;
  for (int gi = 0; gi < ng; ++gi) {
    const int sl = gi % SLOTS;
    hp::bar_wait(&bars[sl], (gi / SLOTS) & 1);
    const uint8_t* hrow = Hs + sl * TM * 128 + ar * 128;
#pragma unroll
    for (int st = 0; st < KG / 16; ++st) {
      if (gi * KG + 16 * st < slice) {
        const int ko = (sl * KG + 16 * st) * 128;
        uint32_t a[4], b[4][4];
        hp::ldsm4(a, hrow + (((2 * st + (ln.a_c >> 3)) ^ ax) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (q + 4 * i < np) hp::ldsm4_t(b[i], wb[i] + ko);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (q + 4 * i < np)
#pragma unroll
            for (int f = 0; f < 2; ++f)
              hp::mma16816(acc[i][f], a, b[i][2 * f], b[i][2 * f + 1]);
      }
    }
    if (gi + SLOTS < ng) {
      __syncthreads();                // slot sl is read
      if (tid == 0) issue(gi + SLOTS, true);
    }
  }

  // send each row of the partial tile to the rank that finishes it: row m
  // to rank m / rpr, as its row (this rank, m % rpr)
  hp::cluster_wait();                 // every rank has started
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (q + 4 * i < np)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = 16 * mh + g + 8 * hf;
          hp::st_dsmem2(Rv + (rank * rpr + m % rpr) * PS + 16 * (q + 4 * i) +
                            8 * f + 2 * t4,
                        m / rpr,
                        make_float2(acc[i][f][2 * hf],
                                    acc[i][f][2 * hf + 1]));
        }
  hp::cluster_sync();                 // every partial row has arrived

  // the logits of this rank's rows: the partial rows in rank order
  const int vq = vp / 4;
  for (int idx = tid; idx < rpr * vq; idx += NT) {
    const int r = idx / vq, c = (idx % vq) * 4;
    float4 sum = *reinterpret_cast<const float4*>(Rv + r * PS + c);
    for (int s = 1; s < cs; ++s) {
      const float4 v =
          *reinterpret_cast<const float4*>(Rv + (s * rpr + r) * PS + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<float4*>(Lr + r * PS + c) = sum;
  }
  __syncthreads();
  for (int r = warp; r < rpr; r += NT / 32) {
    const float* op = rowop + 4 * r;
    row_loss<BWD>(Lr + r * PS, V, n0 + rb + r, N, __float_as_int(op[0]),
                  op[1], op[2], op[3], coefs, sigma, rowv + r * 8, dlogits);
  }
  __syncthreads();

  if constexpr (!BWD) {
    if (tid < 8) {
      float s = 0.f;
      for (int r = 0; r < rpr; ++r) s += rowv[r * 8 + tid];
      partials[((long)tile * cs + rank) * 8 + tid] = s;
    }
  } else {
    // send this rank's rows of d (columns past Va hold the zero logits
    // there) to every rank, as rows rb.. of its gathered tile
    for (int idx = tid; idx < cs * rpr * vq; idx += NT) {
      const int s = idx / (rpr * vq), r = idx / vq % rpr;
      const int c = (idx % vq) * 4;
      hp::st_dsmem4(Dt + (rb + r) * PS + c, s,
                    *reinterpret_cast<const float4*>(Lr + r * PS + c));
    }
    hp::cluster_sync();               // the tile's d has arrived

    // dh[tile rows, slice] = d . w[slice]^T, a window of SLOTS groups of the
    // slice at a time, from the last (the forward left its groups in the
    // slots) to the first, reloading the groups a window lacks: warp (mh, q)
    // takes rows 16 mh.. and the window's column pairs q, q + 4, q + 8,
    // q + 12; d in three terms
    const int jx = ln.b_n & 7;
    const uint8_t* wp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wp[i] = Ws + (16 * (q + 4 * i) + ln.b_n) * 128;
    int held[SLOTS], uses[SLOTS];     // a slot's group, and its loads so far
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      uses[sl] = sl < ng ? (ng - 1 - sl) / SLOTS + 1 : 0;
      held[sl] = sl + (uses[sl] - 1) * SLOTS;
    }
    for (int g0 = (ng - 1) / SLOTS * SLOTS; g0 >= 0; g0 -= SLOTS) {
      bool lacks[SLOTS], any = false;
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) {
        lacks[sl] = g0 + sl < ng && held[sl] != g0 + sl;
        any |= lacks[sl];
      }
      if (any) {
        __syncthreads();              // the slots are read
        if (tid == 0)
#pragma unroll
          for (int sl = 0; sl < SLOTS; ++sl)
            if (lacks[sl]) issue(g0 + sl, false);
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl)
          if (lacks[sl]) {
            hp::bar_wait(&bars[sl], uses[sl]++ & 1);
            held[sl] = g0 + sl;
          }
      }
      const int spn = min(WIN, slice - g0 * KG) / 16;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;
      for (int kk = 0; kk < vp; kk += 16) {
        const int wo = (kk >> 6) * wr * 128 +
                       (((((kk >> 3) & 7) + (ln.b_k >> 3)) ^ jx) << 4);
        const float* d0 = Dt + (16 * mh + g) * PS + kk + 2 * t4;
        const float2 x00 = *reinterpret_cast<const float2*>(d0);
        const float2 x10 = *reinterpret_cast<const float2*>(d0 + 8 * PS);
        const float2 x01 = *reinterpret_cast<const float2*>(d0 + 8);
        const float2 x11 = *reinterpret_cast<const float2*>(d0 + 8 * PS + 8);
        uint32_t ta[3][4], b[4][4];
        hp::split3(x00.x, x00.y, ta[0][0], ta[1][0], ta[2][0]);
        hp::split3(x10.x, x10.y, ta[0][1], ta[1][1], ta[2][1]);
        hp::split3(x01.x, x01.y, ta[0][2], ta[1][2], ta[2][2]);
        hp::split3(x11.x, x11.y, ta[0][3], ta[1][3], ta[2][3]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (q + 4 * i < spn) hp::ldsm4(b[i], wp[i] + wo);
        // the three terms' products of each of the 8 tiles summed from zero
        // (hi, mid, lo), issued term by term so that the 8 sums interleave
        float t[4][2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) t[i][f][e] = 0.f;
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (q + 4 * i < spn)
#pragma unroll
              for (int f = 0; f < 2; ++f)
                hp::mma16816(t[i][f], ta[u], b[i][2 * f], b[i][2 * f + 1]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (q + 4 * i < spn)
#pragma unroll
            for (int f = 0; f < 2; ++f)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][f][e] += t[i][f][e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = q + 4 * i;
        if (p < spn)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int k = g0 * KG + 16 * p + 8 * f + 2 * t4;
            if (k >= kn) continue;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int n = n0 + 16 * mh + g + 8 * hf;
              if (n < N)
                *reinterpret_cast<uint32_t*>(dh + (long)n * D + k0 + k) =
                    hp::pack_bf16(acc[i][f][2 * hf], acc[i][f][2 * hf + 1]);
            }
          }
      }
    }
  }
}

// dw [D, V] = sum_n h[n]^T d[n], bf16 h, in bf16: a CTA takes DW_TJ = 64
// rows of dw x DW_TV columns and walks all N rows in order, DW_KC at a
// time, through a ring of DW_STAGES stages that TMA fills (hidden: boxes of
// 64 x 64, 128-byte swizzle; d: boxes of 64 x 64 f32); d is split into
// three bf16 terms in shared memory. Warp (mq, nh): rows 16 mq.., columns
// 32 nh.. of the tile. 100 KB of shared memory, two CTAs an SM: at d 4096
// and Va 256 the grid is 256 CTAs. Launched as the row kernel's dependent:
// hidden's first boxes are requested before it waits for that grid's d.
constexpr int DW_TJ = 64, DW_TV = 64, DW_KC = 64, DW_STAGES = 3;
constexpr int DW_TS = DW_TV + 8;
constexpr int DW_H_BYTES = DW_KC * DW_TJ * 2;
constexpr int DW_D_BYTES = DW_KC * DW_TV * 4;
constexpr int DW_STAGE = DW_H_BYTES + DW_D_BYTES;
constexpr size_t DW_SMEM = (size_t)DW_STAGES * DW_STAGE +
                           3 * DW_KC * DW_TS * 2 + DW_STAGES * 8 + 1024;

__global__ void __launch_bounds__(NT, 2)
policy_dw_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap dmap,
                    bf16* __restrict__ dw, int N, int D, int V) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = hp::align1024(smem_raw);
  bf16* Tt = reinterpret_cast<bf16*>(smem + DW_STAGES * DW_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + DW_STAGES * DW_STAGE + 3 * DW_KC * DW_TS * 2);
  const int j0 = blockIdx.x * DW_TJ, v0 = blockIdx.y * DW_TV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mq = warp & 3, nh = warp >> 2;
  const hp::Lane ln(lane);
  const int nch = (N + DW_KC - 1) / DW_KC;

  // chunk c's boxes into stage c % DW_STAGES (thread 0)
  auto load_h = [&](int c) {
    uint64_t* bar = &full[c % DW_STAGES];
    hp::bar_expect(bar, DW_STAGE);
    hp::tma_load_2d(smem + (c % DW_STAGES) * DW_STAGE, &hmap, bar, j0,
                    c * DW_KC);
  };
  auto load_d = [&](int c) {
    hp::tma_load_2d(smem + (c % DW_STAGES) * DW_STAGE + DW_H_BYTES, &dmap,
                    &full[c % DW_STAGES], v0, c * DW_KC);
  };
  if (tid == 0) {
    hp::prefetch_map(&hmap);
    hp::prefetch_map(&dmap);
    for (int s = 0; s < DW_STAGES; ++s) hp::bar_init(&full[s], 1);
    hp::bar_init_fence();
    for (int c = 0; c < min(nch, DW_STAGES - 1); ++c) load_h(c);
    hp::griddep_wait();               // the row kernel's d
    for (int c = 0; c < min(nch, DW_STAGES - 1); ++c) load_d(c);
  }
  __syncthreads();                    // the barriers are initialised

  // hidden^T's A fragments: rows (of N) kk + at_k, columns 16 mq + at_m of
  // the swizzled box; every k step starts on a multiple of 16 rows
  const int ha = ln.at_k * 128 +
                 ((((16 * mq + ln.at_m) >> 3) ^ (ln.at_k & 7)) << 4);
  const bf16* tb = Tt + ln.bt_k * DW_TS + 32 * nh + ln.bt_n;
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    // the stage of chunk c - 1 is free again (the loop's last barrier)
    if (tid == 0 && c + DW_STAGES - 1 < nch) {
      load_h(c + DW_STAGES - 1);
      load_d(c + DW_STAGES - 1);
    }
    hp::bar_wait(&full[c % DW_STAGES], (c / DW_STAGES) & 1);
    const uint8_t* hs = smem + (c % DW_STAGES) * DW_STAGE;
    const float* ds = reinterpret_cast<const float*>(hs + DW_H_BYTES);
    // d's rows of this chunk in three bf16 terms
    for (int idx = tid; idx < DW_KC * (DW_TV / 4); idx += NT) {
      const int r = idx / (DW_TV / 4), cc = (idx % (DW_TV / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(ds + r * DW_TV + cc);
      uint2 th, tm, tl;
      hp::split3(x.x, x.y, th.x, tm.x, tl.x);
      hp::split3(x.z, x.w, th.y, tm.y, tl.y);
      *reinterpret_cast<uint2*>(Tt + r * DW_TS + cc) = th;
      *reinterpret_cast<uint2*>(Tt + (DW_KC + r) * DW_TS + cc) = tm;
      *reinterpret_cast<uint2*>(Tt + (2 * DW_KC + r) * DW_TS + cc) = tl;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DW_KC; kk += 16) {
      uint32_t a[4], b[3][2][4];
      hp::ldsm4_t(a, hs + ha + kk * 128);
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hp::ldsm4_t(b[u][i], tb + (u * DW_KC + kk) * DW_TS + 16 * i);
      // each tile's three products summed from zero (hi, mid, lo), term by
      // term across the 4 tiles, then added in f32
      float t[2][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[i][f][e] = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int f = 0; f < 2; ++f)
            hp::mma16816(t[i][f], a, b[u][i][2 * f], b[u][i][2 * f + 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][f][e] += t[i][f][e];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int v = v0 + 32 * nh + 16 * i + 8 * f + 2 * t4;
      if (v >= V) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = j0 + 16 * mq + g + 8 * hf;
        if (j < D)
          *reinterpret_cast<uint32_t*>(dw + (long)j * V + v) =
              hp::pack_bf16(acc[i][f][2 * hf], acc[i][f][2 * hf + 1]);
      }
    }
}

bool bad_shape(int N, int D, int V) {
  return N <= 0 || D <= 0 || D % 8 != 0 || V % 8 != 0 || V < 8 || V > MAX_V;
}

template <bool BWD>
int launch_cluster(const void* h, const void* w, const void* targets,
                   const void* logp_old, const void* adv, const void* mask,
                   const void* coefs, void* partials, void* dh,
                   void* dlogits, int N, int D, int V, float sigma,
                   cudaStream_t st) {
  const ClusterPlan pl = cluster_plan(D, V, BWD);
  const int tiles = (N + TM - 1) / TM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  int err = hp::make_map_2d(&hmap, h, false, N, D, TM, 64);
  if (err == 0) err = hp::make_map_2d(&wmap, w, false, D, V, KG, 64);
  if (err != 0) return err;
  auto kern = policy_cluster_kernel<BWD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
  if (e == cudaSuccess && pl.cs > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return repro::refused(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cs, tiles);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = pl.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kern, hmap, wmap, static_cast<const int*>(targets),
      static_cast<const float*>(logp_old), static_cast<const float*>(adv),
      static_cast<const float*>(mask), static_cast<const float*>(coefs),
      static_cast<float*>(partials), static_cast<bf16*>(dh),
      static_cast<float*>(dlogits), N, D, V, sigma);
  if (e != cudaSuccess) return repro::refused(e);
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch_rows(const void* h, const void* w, const void* targets,
                  const void* logp_old, const void* adv, const void* mask,
                  const void* coefs, void* partials, void* dh, void* dlogits,
                  int N, int D, int V, int dtype, float sigma,
                  cudaStream_t st) {
  if (dtype == repro::DTYPE_BF16)
    return launch_cluster<BWD>(h, w, targets, logp_old, adv, mask, coefs,
                               partials, dh, dlogits, N, D, V, sigma, st);
  if (dtype != repro::DTYPE_F32) return (int)cudaErrorInvalidValue;
  policy_rows_kernel<BWD><<<(N + BN - 1) / BN, NT, 0, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(targets), static_cast<const float*>(logp_old),
      static_cast<const float*>(adv), static_cast<const float*>(mask),
      static_cast<const float*>(coefs), static_cast<float*>(partials),
      static_cast<float*>(dh), static_cast<float*>(dlogits), N, D, V, sigma);
  return (int)cudaGetLastError();
}


// ---- K5: the loss over given logits, streaming body (V > HEAD_MAX_V) ------

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

// ---- K5: the register body (V <= HEAD_MAX_V) -------------------------------

constexpr int HEAD_MAX_V = 1024;   // the register body's limit on V
constexpr int HEAD_MAX_WARPS = 4;  // warps a CTA
constexpr int HEAD_VECS = 8;       // 16-byte vectors a lane, at most
constexpr int HEAD_STAGES = 2;     // steps of rows in flight a CTA
// a stage's bytes at most: a step's rows fill at most HEAD_VECS vectors a
// lane, plus 32 bytes of rounding, to 128 bytes
constexpr int HEAD_STAGE_MAX = HEAD_MAX_WARPS * 32 * HEAD_VECS * 16 + 128;
static_assert(HEAD_STAGES * (HEAD_STAGE_MAX + 8) <= 48 * 1024,
              "the ring fits a CTA's default shared memory");

// The card's SMs, asked of the runtime once (the cards of a process are
// alike); 0 if it cannot say. The plan and the grid both size from it.
inline int head_sms() {
  static std::atomic<int> sms{0};
  int n = sms.load(std::memory_order_relaxed);
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    sms.store(n, std::memory_order_relaxed);
  }
  return n;
}

// Lanes a row (0: the streaming body), 16-byte vectors a lane, warps a CTA.
struct HeadPlan {
  int lanes, vecs, warps;
};

inline HeadPlan head_plan(int N, int V, int dtype) {
  HeadPlan p{0, 0, 0};
  if (N <= 0 || V <= 0 || V > HEAD_MAX_V ||
      (dtype != repro::DTYPE_F32 && dtype != repro::DTYPE_BF16))
    return p;
  const long sms = head_sms();
  const int w = dtype == repro::DTYPE_BF16 ? 8 : 4;     // elements a vector
  const int chunks = (V + w - 1) / w;
  // the fewest lanes (4 to 32) whose HEAD_VECS vectors hold the row; 32
  // where that leaves fewer rows than 4 warps an SM
  p.lanes = 4;
  while (p.lanes * HEAD_VECS < chunks) p.lanes *= 2;
  if ((long)N * p.lanes < 4L * sms * 32) p.lanes = 32;
  p.vecs = 1;
  while (p.vecs * p.lanes < chunks) p.vecs *= 2;
  const long warps = ((long)N * p.lanes + 31) / 32;
  p.warps = HEAD_MAX_WARPS;
  while (p.warps > 1 && (warps + p.warps - 1) / p.warps < sms)
    p.warps /= 2;
  return p;
}

// token rows a partial row of the forward sums: a warp's (register body) or
// a CTA's (streaming body)
inline int head_block_rows(const HeadPlan& p) {
  return p.lanes ? 32 / p.lanes : HEAD_ROWS;
}

// One 16-byte vector of a row, read from the stage: its elements as f32,
// and a 16-byte streaming store of d_logits.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void fill(float v) {
    raw = make_float4(v, v, v, v);
  }
  __device__ __forceinline__ void get(float (&f)[4]) const {
    f[0] = raw.x; f[1] = raw.y; f[2] = raw.z; f[3] = raw.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&f)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  }
};
template <>
struct Vec<bf16> {
  uint4 raw;
  __device__ __forceinline__ void load(const bf16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void fill(float v) {
    const uint32_t u = hp::pack_bf16(v, v);
    raw = make_uint4(u, u, u, u);
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = hp::unpack_bf16(u[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p,
                                               const float (&f)[8]) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(hp::pack_bf16(f[0], f[1]), hp::pack_bf16(f[2], f[3]),
                      hp::pack_bf16(f[4], f[5]), hp::pack_bf16(f[6], f[7])));
  }
};

// The largest element of a lane's NV vectors
template <int NV>
__device__ __forceinline__ float vec_max(const Vec<float> (&v)[NV]) {
  float m = v[0].raw.x;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    m = fmaxf(fmaxf(fmaxf(m, v[k].raw.x), fmaxf(v[k].raw.y, v[k].raw.z)),
              v[k].raw.w);
  return m;
}
template <int NV>
__device__ __forceinline__ float vec_max(const Vec<bf16> (&v)[NV]) {
  auto h2 = [](uint32_t u) {
    return *reinterpret_cast<const __nv_bfloat162*>(&u);
  };
  __nv_bfloat162 m = __hmax2(h2(v[0].raw.x), h2(v[0].raw.y));
#pragma unroll
  for (int k = 0; k < NV; ++k)
    m = __hmax2(__hmax2(m, __hmax2(h2(v[k].raw.x), h2(v[k].raw.y))),
                __hmax2(h2(v[k].raw.z), h2(v[k].raw.w)));
  const float2 f = __bfloat1622float2(m);
  return fmaxf(f.x, f.y);
}

constexpr float HEAD_LOG2E = 1.4426950408889634f;

// e^sh as 2^(sh log2 e), in base 2 as K1's softmax (ex2.approx, flushing
// results below 2^-126 to zero; the max's e is exactly 1)
__device__ __forceinline__ float head_exp(float sh) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(sh * HEAD_LOG2E));
  return e;
}

// K5's element of d, from p = e / S (one reciprocal a row): the arithmetic
// of `dlogit` after its exponential and divide
__device__ __forceinline__ float head_dlogit(float p, float sh, float lse,
                                             float ent, bool is_tgt, float g,
                                             float ce) {
  return g * ((is_tgt ? 1.f : 0.f) - p) + ce * (-(p * ((sh - lse) + ent)));
}

// One element of the pass after the max: sh = s - m, e = e^sh, and the
// lane's running sums in the lane's element order (S from 0, U = sum e sh
// by fused multiply-add).
__device__ __forceinline__ float head_push(float x, float mx, float& S,
                                           float& U) {
  const float sh = x - mx;
  const float e = head_exp(sh);
  S += e;
  U = fmaf(e, sh, U);
  return e;
}

// The operands of a token row (-1, 0, 0, 0 past N)
struct HeadOps {
  int tgt;
  float lo, ad, m;
  __device__ __forceinline__ void load(const int* __restrict__ targets,
                                       const float* __restrict__ logp_old,
                                       const float* __restrict__ adv,
                                       const float* __restrict__ mask,
                                       long n, int N) {
    const bool ok = n < N;
    tgt = ok ? targets[n] : -1;
    lo = ok ? logp_old[n] : 0.f;
    ad = ok ? adv[n] : 0.f;
    m = ok ? mask[n] : 0.f;
  }
};

// The byte range a block of rows [n0, n0 + rows) covers, rounded out to 16
// bytes (the bulk copy's unit), from the logits' 16-byte aligned base.
struct HeadSpan {
  long a0, a1;
};
__device__ __forceinline__ HeadSpan head_span(long n0, int rows, int N,
                                              int V, int esize, int mis) {
  const long end = min((long)N, n0 + rows);
  return {(n0 * V * esize + mis) & ~15L, (end * V * esize + mis + 15) & ~15L};
}

// Forward (BWD = false): one partial row a block of rows. Backward (BWD =
// true): d_logits, whose rows share the logits' offset within 16 bytes.
// A block is one warp's rows (R = 32 / lanes, row r on lanes
// [r lanes, (r + 1) lanes)); a CTA of `warps` warps takes warps
// consecutive blocks a step. The CTAs are persistent and take steps
// blockIdx.x, blockIdx.x + gridDim.x, ...; thread 0 bulk-copies each step's
// logits (the 16-byte chunks covering its rows) into a ring of HEAD_STAGES
// stages in shared memory, HEAD_STAGES - 1 steps ahead of the warps, and
// the warps read their rows from the stage into registers. A row's
// operands come in one step ahead, by plain loads.
template <typename T, int LANES, int NV, bool BWD>
__global__ void __launch_bounds__(HEAD_MAX_WARPS * 32)
gipo_rows_kernel(const T* __restrict__ logits,
                 const int* __restrict__ targets,
                 const float* __restrict__ logp_old,
                 const float* __restrict__ adv,
                 const float* __restrict__ mask,
                 const float* __restrict__ coefs,
                 float* __restrict__ partials, T* __restrict__ dlogits,
                 int N, int V, int stage_bytes, float sigma) {
  constexpr int W = 16 / sizeof(T);
  constexpr int lanes = LANES, rows = 32 / LANES;
  // a row's head and tail hold up to W - 1 elements each: HT a lane
  constexpr int HT = (W - 1 + LANES - 1) / LANES;
  extern __shared__ __align__(128) uint8_t head_smem[];
  uint64_t* full =
      reinterpret_cast<uint64_t*>(head_smem + HEAD_STAGES * stage_bytes);
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = lane % lanes, r = lane / lanes;
  const int step_rows = warps * rows;
  const long nsteps = ((long)N + step_rows - 1) / step_rows;
  const long nblocks = ((long)N + rows - 1) / rows;
  const int mis = (int)(reinterpret_cast<uintptr_t>(logits) & 15);
  const uint8_t* base = reinterpret_cast<const uint8_t*>(logits) - mis;
  float cf[3] = {0.f, 0.f, 0.f};
  if constexpr (BWD) {
    cf[0] = coefs[0];
    cf[1] = coefs[1];
    cf[2] = coefs[2];
  }

  // step q of this CTA into its stage (thread 0)
  auto issue = [&](int q) {
    const long st = blockIdx.x + (long)q * gridDim.x;
    if (st >= nsteps) return;
    const HeadSpan sp = head_span(st * step_rows, step_rows, N, V, sizeof(T),
                                  mis);
    uint64_t* bar = &full[q % HEAD_STAGES];
    hp::bar_expect(bar, (uint32_t)(sp.a1 - sp.a0));
    hp::bulk_load(head_smem + (q % HEAD_STAGES) * stage_bytes, base + sp.a0,
                  (uint32_t)(sp.a1 - sp.a0), bar);
  };
  if (threadIdx.x == 0) {
    for (int q = 0; q < HEAD_STAGES; ++q) hp::bar_init(&full[q], 1);
    hp::bar_init_fence();
    for (int q = 0; q < HEAD_STAGES; ++q) issue(q);
  }
  const int rin = warp * rows + r;           // the row's place in a step
  HeadOps cur, nxt;
  cur.load(targets, logp_old, adv, mask, blockIdx.x * (long)step_rows + rin,
           N);
  __syncthreads();                           // the barriers are initialised

  int q = 0;
  for (long st = blockIdx.x; st < nsteps; st += gridDim.x, ++q) {
    const long n0 = st * step_rows, n = n0 + rin;
    nxt.load(targets, logp_old, adv, mask, n + (long)gridDim.x * step_rows,
             N);
    const bool live = n < N;
    const uint8_t* stage = head_smem + (q % HEAD_STAGES) * stage_bytes;
    hp::bar_wait(&full[q % HEAD_STAGES], (q / HEAD_STAGES) & 1);

    // the row in the stage (its offset within 16 bytes as in global
    // memory), split into head, vectors and tail
    const HeadSpan sp = head_span(n0, step_rows, N, V, sizeof(T), mis);
    const T* row = reinterpret_cast<const T*>(
        stage + ((live ? n : n0) * V * (long)sizeof(T) + mis - sp.a0));
    const int head = min(
        V, (int)(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15)
                 / sizeof(T)));
    const int nvec = (V - head) / W;
    const int tail0 = head + nvec * W, ntail = V - tail0;
    // every row of the warp 16-byte aligned and whole in the lanes'
    // vectors: no head, no tail, no position outside the row
    const bool whole = __all_sync(
        0xffffffffu, live && head == 0 && ntail == 0 && nvec == lanes * NV);
    float xh[HT], xt[HT];
#pragma unroll
    for (int h = 0; h < HT; ++h) xh[h] = xt[h] = repro::NEG_INF;
    Vec<T> v[NV];
    if (whole) {
#pragma unroll
      for (int k = 0; k < NV; ++k) v[k].load(row + (j + k * lanes) * W);
    } else {
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const int c = j + h * lanes;
        if (live && c < head) xh[h] = repro::to_f(row[c]);
        if (live && c < ntail) xt[h] = repro::to_f(row[tail0 + c]);
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (live && j + k * lanes < nvec)
          v[k].load(row + head + (j + k * lanes) * W);
        else
          v[k].fill(repro::NEG_INF);
      }
    }
    const bool hit = live && cur.tgt >= 0 && cur.tgt < V;
    const float tx = hit ? repro::to_f(row[cur.tgt]) : 0.f;

    // the row max
    float mx = vec_max(v);
#pragma unroll
    for (int h = 0; h < HT; ++h) mx = fmaxf(mx, fmaxf(xh[h], xt[h]));
#pragma unroll
    for (int off = lanes / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

    // one pass: e (kept), S and U, in the lane's order: head, vectors, tail
    // (a whole row has neither: its lanes add the vectors alone)
    float S = 0.f, U = 0.f;
    float e[NV][W];
    float eh[HT] = {}, et[HT] = {};
    if (!whole) {
#pragma unroll
      for (int h = 0; h < HT; ++h) eh[h] = head_push(xh[h], mx, S, U);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float x[W];
      v[k].get(x);
#pragma unroll
      for (int i = 0; i < W; ++i) e[k][i] = head_push(x[i], mx, S, U);
    }
    if (!whole) {
#pragma unroll
      for (int h = 0; h < HT; ++h) et[h] = head_push(xt[h], mx, S, U);
    }
#pragma unroll
    for (int off = lanes / 2; off > 0; off >>= 1) {
      S += __shfl_xor_sync(0xffffffffu, S, off);
      U += __shfl_xor_sync(0xffffffffu, U, off);
    }
    const float lse = logf(S);
    const float ent = lse - U / S;
    const float ts = hit ? tx - mx : 0.f;
    const RowTerms t = row_terms(ts - lse, cur.lo, cur.ad, sigma);

    if constexpr (!BWD) {
      // the block's rows' 8 columns, summed in row order from 0: lane j of
      // each row takes columns j, j + lanes, ... (below 8), lane j of the
      // first row sums them
      float pv[8];
      row_partials(pv, t, ent, cur.m, sigma);
      const long blk = st * warps + warp;
#pragma unroll
      for (int c0 = 0; c0 < 8; c0 += lanes) {
        float col = 0.f;
#pragma unroll
        for (int c = c0; c < c0 + lanes && c < 8; ++c)
          col = j == c - c0 ? pv[c] : col;
        col = live ? col : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < rows; ++i)
          sum += __shfl_sync(0xffffffffu, col, i * lanes + j);
        if (lane < 8 - c0 && lane < lanes && blk < nblocks)
          partials[blk * 8 + c0 + lane] = sum;
      }
    } else if (live) {
      // d without its one-hot term, then the target's element again with
      // it, from the lane that holds it (a later store from the same
      // thread): every element as head_dlogit
      T* drow = dlogits + n * V;
      const float m = cur.m;
      const float g = row_g(t, cf, m);
      const float ce = cf[2] * m;
      const float inv = 1.f / S;
      const bool zero = m == 0.f;
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const int c = j + h * lanes;
        if (!whole && c < head)
          drow[c] = repro::from_f<T>(
              zero ? 0.f : head_dlogit(eh[h] * inv, xh[h] - mx, lse, ent,
                                       c == cur.tgt, g, ce));
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = j + k * lanes;
        if (whole || c < nvec) {
          float x[W], d[W];
          v[k].get(x);
#pragma unroll
          for (int i = 0; i < W; ++i)
            d[i] = zero ? 0.f
                        : head_dlogit(e[k][i] * inv, x[i] - mx, lse, ent,
                                      false, g, ce);
          Vec<T>::store(drow + head + c * W, d);
        }
      }
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const int c = j + h * lanes;
        if (!whole && c < ntail)
          drow[tail0 + c] = repro::from_f<T>(
              zero ? 0.f : head_dlogit(et[h] * inv, xt[h] - mx, lse, ent,
                                       tail0 + c == cur.tgt, g, ce));
      }
      // the lane holding the target's vector element fixes it
      const int off = cur.tgt - head;
      if (hit && !zero && off >= 0 && off < nvec * W &&
          (off / W) % lanes == j) {
        const float sh = tx - mx;
        drow[cur.tgt] = repro::from_f<T>(
            head_dlogit(head_exp(sh) * inv, sh, lse, ent, true, g, ce));
      }
    }
    cur = nxt;
    __syncthreads();                         // every warp is done with it
    if (threadIdx.x == 0) issue(q + HEAD_STAGES);
  }
}

// the ring's stage: a step's rows and 32 bytes of rounding, to 128 bytes
inline int head_stage_bytes(const HeadPlan& p, int V, int esize) {
  return ((p.warps * 32 / p.lanes) * V * esize + 32 + 127) / 128 * 128;
}

template <typename T, int LANES, int NV, bool BWD>
int launch_ring(const HeadPlan& p, const void* logits, const void* targets,
                const void* logp_old, const void* adv, const void* mask,
                const void* coefs, void* partials, void* dlogits, int N,
                int V, float sigma, cudaStream_t st) {
  auto kern = gipo_rows_kernel<T, LANES, NV, BWD>;
  const int threads = p.warps * 32;
  const int stage = head_stage_bytes(p, V, sizeof(T));
  if (stage > HEAD_STAGE_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)HEAD_STAGES * stage + HEAD_STAGES * 8;
  // CTAs an SM at these threads and this shared memory, asked of the
  // runtime once a (warps, stage size) and kernel
  static std::atomic<int> occ_of[3][HEAD_STAGE_MAX / 128 + 1];
  std::atomic<int>& slot = occ_of[p.warps / 2][stage / 128];
  int occ = slot.load(std::memory_order_relaxed);
  if (occ == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kern, threads, smem);
    if (e != cudaSuccess) return repro::refused(e);
    slot.store(occ, std::memory_order_relaxed);
  }
  const int step_rows = p.warps * 32 / p.lanes;
  const long steps = ((long)N + step_rows - 1) / step_rows;
  const long grid = min(steps, (long)max(1, head_sms() * occ));
  kern<<<(unsigned)grid, threads, smem, st>>>(
      static_cast<const T*>(logits), static_cast<const int*>(targets),
      static_cast<const float*>(logp_old), static_cast<const float*>(adv),
      static_cast<const float*>(mask), static_cast<const float*>(coefs),
      static_cast<float*>(partials), static_cast<T*>(dlogits), N, V, stage,
      sigma);
  return (int)cudaGetLastError();
}

template <typename T, int LANES, bool BWD>
int launch_lanes(const HeadPlan& p, const void* logits, const void* targets,
                 const void* logp_old, const void* adv, const void* mask,
                 const void* coefs, void* partials, void* dlogits, int N,
                 int V, float sigma, cudaStream_t st) {
#define REPRO_ROWS(NV)                                                       \
  return launch_ring<T, LANES, NV, BWD>(p, logits, targets, logp_old, adv,   \
                                        mask, coefs, partials, dlogits, N, V, \
                                        sigma, st)
  // head_plan gives 8 and 16 lanes a row only with HEAD_VECS vectors, and
  // bf16 rows at 32 lanes fewer (V <= HEAD_MAX_V)
  constexpr bool any = LANES == 4 || LANES == 32;
  switch (p.vecs) {
    case 1: if constexpr (any) REPRO_ROWS(1); break;
    case 2: if constexpr (any) REPRO_ROWS(2); break;
    case 4: if constexpr (any) REPRO_ROWS(4); break;
    case 8:
      if constexpr (LANES < 32 || sizeof(T) == 4) REPRO_ROWS(8);
      break;
    default: break;
  }
#undef REPRO_ROWS
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool BWD>
int launch_rows(const HeadPlan& p, const void* logits, const void* targets,
                const void* logp_old, const void* adv, const void* mask,
                const void* coefs, void* partials, void* dlogits, int N,
                int V, float sigma, cudaStream_t st) {
  switch (p.lanes) {
    case 4:
      return launch_lanes<T, 4, BWD>(p, logits, targets, logp_old, adv, mask,
                                     coefs, partials, dlogits, N, V, sigma,
                                     st);
    case 8:
      return launch_lanes<T, 8, BWD>(p, logits, targets, logp_old, adv, mask,
                                     coefs, partials, dlogits, N, V, sigma,
                                     st);
    case 16:
      return launch_lanes<T, 16, BWD>(p, logits, targets, logp_old, adv,
                                      mask, coefs, partials, dlogits, N, V,
                                      sigma, st);
    case 32:
      return launch_lanes<T, 32, BWD>(p, logits, targets, logp_old, adv,
                                      mask, coefs, partials, dlogits, N, V,
                                      sigma, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool BWD>
int launch_head(const void* logits, const void* targets, const void* logp_old,
                const void* adv, const void* mask, const void* coefs,
                void* partials, void* dlogits, int N, int V, int dtype,
                float sigma, cudaStream_t st) {
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != repro::DTYPE_F32 && dtype != repro::DTYPE_BF16)
    return (int)cudaErrorInvalidValue;
  if (head_sms() == 0) return repro::refused(cudaErrorNoDevice);
  const HeadPlan p = head_plan(N, V, dtype);
  if (p.lanes) {
    return dtype == repro::DTYPE_F32
               ? launch_rows<float, BWD>(p, logits, targets, logp_old, adv,
                                         mask, coefs, partials, dlogits, N, V,
                                         sigma, st)
               : launch_rows<bf16, BWD>(p, logits, targets, logp_old, adv,
                                        mask, coefs, partials, dlogits, N, V,
                                        sigma, st);
  }
  const int nb = (N + HEAD_ROWS - 1) / HEAD_ROWS;
#define REPRO_HEAD(T)                                                       \
  gipo_head_kernel<T, BWD><<<nb, HEAD_ROWS * 32, 0, st>>>(                  \
      static_cast<const T*>(logits), static_cast<const int*>(targets),      \
      static_cast<const float*>(logp_old), static_cast<const float*>(adv),  \
      static_cast<const float*>(mask), static_cast<const float*>(coefs),    \
      static_cast<float*>(partials), static_cast<T*>(dlogits), N, V, sigma)
  if (dtype == repro::DTYPE_F32) {
    REPRO_HEAD(float);
  } else {
    REPRO_HEAD(__nv_bfloat16);
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

// lanes a row of K5's register body, 0 where the shape runs the streaming
// body (V > HEAD_MAX_V) or is refused
extern "C" int gipo_head_lanes(int N, int V, int dtype) {
  return head_plan(N, V, dtype).lanes;
}

// token rows each partial row of gipo_head_fwd sums (0 for a shape it
// refuses)
extern "C" int gipo_head_block_rows(int N, int V, int dtype) {
  if (N <= 0 || V <= 0 ||
      (dtype != repro::DTYPE_F32 && dtype != repro::DTYPE_BF16))
    return 0;
  return head_block_rows(head_plan(N, V, dtype));
}

// rows of the partial sums gipo_head_fwd writes (0 for a shape it refuses)
extern "C" int gipo_head_partial_rows(int N, int V, int dtype) {
  const int rows = gipo_head_block_rows(N, V, dtype);
  return rows ? (int)(((long)N + rows - 1) / rows) : 0;
}

// rows of d a rank of K4's tensor-core body takes (bf16), 0 where the shape
// runs the FMA body (f32) or is refused
extern "C" int policy_loss_slice(int N, int D, int V, int dtype) {
  return bad_shape(N, D, V) || dtype != repro::DTYPE_BF16
             ? 0
             : cluster_plan(D, V, false).slice;
}

// rows of the partial sums policy_loss_fwd writes (0 for a shape it refuses)
extern "C" int policy_loss_partial_rows(int N, int D, int V, int dtype) {
  if (bad_shape(N, D, V)) return 0;
  if (dtype == repro::DTYPE_BF16)
    return (N + TM - 1) / TM * cluster_plan(D, V, false).cs;
  return (N + BN - 1) / BN;
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

// dw is written in the inputs' dtype; dlogits is an f32 [N, V] scratch
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
  if (dtype == repro::DTYPE_F32) {
    const dim3 grid((D + DW_T - 1) / DW_T, (V + DW_T - 1) / DW_T);
    policy_dw_kernel<<<grid, NT, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(dlogits),
        static_cast<float*>(dw), N, D, V);
    return (int)cudaGetLastError();
  }
  CUtensorMap hmap, dmap;
  err = hp::make_map_2d(&hmap, h, false, N, D, DW_KC, DW_TJ);
  if (err == 0) err = hp::make_map_2d(&dmap, dlogits, true, N, V, DW_KC,
                                      DW_TV);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      policy_dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DW_SMEM);
  if (e != cudaSuccess) return repro::refused(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + DW_TJ - 1) / DW_TJ, (V + DW_TV - 1) / DW_TV);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = DW_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, policy_dw_tc_kernel, hmap, dmap,
                         static_cast<bf16*>(dw), N, D, V);
  if (e != cudaSuccess) return repro::refused(e);
  return (int)cudaGetLastError();
}
