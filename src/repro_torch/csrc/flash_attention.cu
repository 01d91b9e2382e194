// Causal (optionally sliding-window) GQA flash attention, forward, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`_attn_kernel`, launched by `flash_attention`). Same function: q [B,T,H,D],
// k/v [B,S,KV,D] (f32 or bf16, contiguous) -> o [B,T,H,D] in q's dtype and,
// on request, the per-row log-sum-exp lse [B,T,H] f32. Positions count from
// 0 on both sides: key kpos is visible to query qpos iff kpos < S, and
// kpos <= qpos when causal, and qpos - kpos < window when a window is set.
//
// What bounds it on the H100: at the openvla-7b prompt shapes (B=8,
// T=S=268, H=32, D=128, bf16) it moves ~70 MB (q, k, v and o once each) and
// does ~4.7 GFLOP of causal work, so the memory bound (~21 us at 3.35 TB/s)
// is above the tensor-core bound (~5 us at 989 TFLOP/s). At these short
// sequences a CTA sees one to five key tiles, so what decides its time is
// how much of the loads' latency is hidden behind the tensor cores.
//
// Design: one CTA per (q tile, head, batch). The TPU grid's sequential kv
// axis becomes a loop inside the CTA over 64-key tiles. The CTA reads its
// K/V head h / (H / KV) directly: no KV duplication. Tiles fully above the
// causal diagonal or before the window start are skipped; the ragged edges
// are masked here (kpos < S for keys, no store for qpos >= T) instead of
// padding on the host. Masked scores are -inf, so they contribute
// exp(-inf) = 0 while m keeps the finite NEG_INF sentinel.
//
// Two bodies, chosen by what the inputs are: bf16 with D % 16 == 0 and
// D <= 128 (every model's attention) runs the Hopper body below: TMA loads
// into a ring of shared-memory stages, wgmma for both products, one producer
// warp and one consumer warpgroup (flash_fwd_hopper_kernel). f32,
// and bf16 heads outside that range, run the products as f32 FMAs out of
// shared memory (flash_fwd_kernel), which is limited by shared-memory
// bandwidth and FMA issue.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::NEG_INF;

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 256; // 16 x 16 thread grid, 4 x 4 score micro-tiles

size_t smem_bytes(int D) {
  const int DP = D + 4;
  return sizeof(float) *
         ((size_t)BQ * DP + (size_t)BK * DP + (size_t)BK * D +
          (size_t)BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Tq, int S, int H, int KV, int D,
                 int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  // Q/K rows are padded to D + 4 floats: 16-byte aligned for float4 reads,
  // and rows that neighbouring threads read fall in different banks.
  const int DP = D + 4;
  float* Qs = smem;                  // [BQ][DP]
  float* Ks = Qs + BQ * DP;          // [BK][DP]
  float* Vs = Ks + BK * DP;          // [BK][D]
  float* Ps = Vs + BK * D;           // [BQ][BK + 1] scores, then weights
  float* m_s = Ps + BQ * (BK + 1);   // [BQ] running max
  float* l_s = m_s + BQ;             // [BQ] running sum
  float* c_s = l_s + BQ;             // [BQ] this tile's rescale factor

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  const long q_row = (long)H * D;    // stride between positions of q / o
  const long k_row = (long)KV * D;   // stride between positions of k / v
  const T* qb = q + (long)b * Tq * q_row + (long)h * D;
  const T* kb = k + (long)b * S * k_row + (long)kvh * D;
  const T* vb = v + (long)b * S * k_row + (long)kvh * D;

  // 8 elements per thread and step: one or two 16-byte loads
  for (int idx = tid; idx < BQ * (D / 8); idx += NTHREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int qpos = q0 + r;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (qpos < Tq) repro::load8(qb + qpos * q_row + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) Qs[r * DP + c + i] = f[i];
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // kv tiles that any row of this q tile can see
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll 4
    for (int idx = tid; idx < BK * (D / 8); idx += NTHREADS) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const int kpos = k0 + r;
      float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kpos < S) {
        repro::load8(kb + kpos * k_row + c, kf);
        repro::load8(vb + kpos * k_row + c, vf);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        Ks[r * DP + c + i] = kf[i];
        Vs[r * D + c + i] = vf[i];
      }
    }
    __syncthreads();

    // scores for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * DP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qpos = q0 + r, kpos = k0 + c;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        Ps[r * (BK + 1) + c] = ok ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    // online softmax: each warp owns BQ / 8 rows, two keys per lane
    for (int rr = 0; rr < BQ / (NTHREADS / 32); ++rr) {
      const int r = warp * (BQ / (NTHREADS / 32)) + rr;
      float* pr = Ps + r * (BK + 1);
      const float x0 = pr[lane], x1 = pr[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, repro::warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float sum = repro::warp_sum(p0 + p1);
      pr[lane] = repro::round_to<T>(p0);
      pr[lane + 32] = repro::round_to<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < D ? Vs[c * D + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
    if (qpos >= Tq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    T* orow = o + ((long)b * Tq + qpos) * q_row + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) orow[col] = repro::from_f<T>(acc[i][j] / denom);
    }
    if (lse != nullptr && tx == 0)
      lse[((long)b * Tq + qpos) * H + h] = m_s[r] + logf(denom);
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Tq, int S, int H, int KV, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return repro::refused(err);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, NJ><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Tq, S, H, KV, D, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nj(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int Tq, int S, int H, int KV, int D, int causal,
              int window, float scale, cudaStream_t stream) {
#define REPRO_NJ(n)                                                        \
  case n:                                                                  \
    return launch<T, n>(q, k, v, o, lse, B, Tq, S, H, KV, D, causal, window, \
                        scale, stream);
  switch ((D + 15) / 16) {
    REPRO_NJ(1) REPRO_NJ(2) REPRO_NJ(3) REPRO_NJ(4) REPRO_NJ(5) REPRO_NJ(6)
    REPRO_NJ(7) REPRO_NJ(8) REPRO_NJ(9) REPRO_NJ(10) REPRO_NJ(11)
    REPRO_NJ(12) REPRO_NJ(13) REPRO_NJ(14) REPRO_NJ(15) REPRO_NJ(16)
  }
#undef REPRO_NJ
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 with D a multiple of 16 up to 128 (every attention the models run):
// a warp-specialised Hopper body. One producer warp streams the CTA's K and
// V tiles (64 keys each) by TMA through a ring of NSLOT single-tile
// shared-memory slots, in the order K0, V0, K1, V1, ..., each slot with an
// mbarrier full/empty pair. One consumer warpgroup, the CTA's 64 query
// rows, runs S = Q K^T on wgmma from shared memory (Q and K K-major), the
// online softmax in registers, and O += P V on wgmma with P as the
// register A operand (rounded to bf16, as the reference casts p to v's
// type) and V read MN-major through the transpose bit. A K slot is freed
// as soon as its S product is done; a tile's P V stays in flight while the
// next tile's S product runs. Heads narrower than 64 or 128 are padded to
// DP by TMA's zero fill, as are rows past T and keys past S (keys then
// masked). Scores are scaled by scale * log2(e) and exponentiated with
// exp2f; the mask is evaluated only on tiles that cross the diagonal, the
// window edge or S. The LSE leaves in natural log.
//
// At these short sequences a CTA sees one to five key tiles, so what hides
// the loads' latency is CTAs in flight, not ring depth: the shared memory
// (Q and NSLOT tiles) and the register cap (launch bounds) are sized for
// 3 CTAs an SM at D = 128 and 4 at D = 64. Measured on the H100 (PERF.md):
// 64 query rows a CTA at every T of the main path beat 128-row CTAs (two
// consumer warpgroups sharing each K/V tile: ~150 registers a thread, one
// CTA an SM), and a deeper ring did not help at D = 128.
// ---------------------------------------------------------------------------

namespace hp = repro::hopper;

constexpr int HB_K = 64;          // keys per tile

template <int DP, int NSLOT>
struct FwdLayout {                // byte offsets in aligned shared memory
  static constexpr int TILE = (DP / 64) * hp::CHUNK_BYTES;  // 64 rows
  static constexpr int SLOT_OFF = TILE;                     // after Q
  static constexpr int BAR_OFF = SLOT_OFF + NSLOT * TILE;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * NSLOT) + 1024;
};

// The ring's items in order: K of tile 0, V of tile 0, K of tile 1, ...;
// item i lands in slot i % NSLOT, in that slot's round i / NSLOT.
template <int NSLOT>
struct Item {
  int slot, parity;
  __device__ __forceinline__ explicit Item(int i)
      : slot(i % NSLOT), parity((i / NSLOT) & 1) {}
};

template <int DP, int NSLOT, int MINB>
__global__ void __launch_bounds__(160, MINB)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int Tq, int S, int H, int KV,
                        int D, int causal, int window, float scale_log2) {
  using L = FwdLayout<DP, NSLOT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hp::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NSLOT;
  const uint8_t* slots = smem + L::SLOT_OFF;

  // the last q tiles, which see the most keys, go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // kv tiles that any row of this CTA can see
  const int q_last = min(q0 + 64, Tq) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int k_begin =
      (window > 0 ? max(0, q0 - window + 1) : 0) / HB_K * HB_K;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + HB_K - 1) / HB_K
                                      : 0;

  if (threadIdx.x == 0) {
    hp::bar_init(q_full, 1);
    for (int s = 0; s < NSLOT; ++s) {
      hp::bar_init(&full[s], 1);
      hp::bar_init(&empty[s], 128);
    }
    hp::bar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {                        // the producer warp
    if (lane == 0) {
      hp::prefetch_map(&qmap);
      hp::prefetch_map(&kmap);
      hp::prefetch_map(&vmap);
      hp::bar_expect(q_full, L::TILE);
      hp::tma_rows<DP>(smem, &qmap, q_full, h, q0, b);
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const Item<NSLOT> it(i);
        if (i >= NSLOT) hp::bar_wait(&empty[it.slot], it.parity ^ 1);
        hp::bar_expect(&full[it.slot], L::TILE);
        hp::tma_rows<DP>(smem + L::SLOT_OFF + it.slot * L::TILE,
                         (i & 1) ? &vmap : &kmap, &full[it.slot], kvh,
                         k_begin + (i / 2) * HB_K, b);
      }
    }
    return;
  }

  // the consumer warpgroup: rows q0 .. q0 + 63
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;   // this thread's rows

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // A tile's K slot is released once S = Q K^T is done. Its P V product
  // stays in flight while the next tile's S product runs; its V slot is
  // released once both are done.
  uint32_t pa[4][4];
  int v_pending = -1;
  hp::bar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * HB_K;
    const Item<NSLOT> ik(2 * j), iv(2 * j + 1);
    const uint8_t* Ks = slots + ik.slot * L::TILE;
    const uint8_t* Vs = slots + iv.slot * L::TILE;
    hp::bar_wait(&full[ik.slot], ik.parity);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hp::wgmma_ss(sc, hp::desc_k(smem, kk), hp::desc_k(Ks, kk), kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(acc);
    hp::fence_regs(pa);
    hp::bar_arrive(&empty[ik.slot]);
    if (v_pending >= 0) hp::bar_arrive(&empty[v_pending]);

    const bool masked = k0 + HB_K > S || (causal && k0 + HB_K - 1 > q0) ||
                        (window > 0 && q0 + 63 - k0 >= window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = __fmul_rn(sc[i], scale_log2);
      if (masked) {
        const int row = (i & 2) ? r1 : r0;
        const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        bool ok = key < S;
        if (causal) ok = ok && key <= row;
        if (window > 0) ok = ok && row - key < window;
        x = ok ? x : -INFINITY;
      }
      sc[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    // the four threads of a quad hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(sc[i] - ((i & 2) ? mn1 : mn0));
      sc[i] = p;
      if (i & 2) sum1 += p; else sum0 += p;
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hp::a_frag(pa[kk], sc, kk);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
    hp::bar_wait(&full[iv.slot], iv.parity);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::wgmma_rs(acc, pa[kk], hp::desc_mn(Vs, kk));
    hp::wgmma_commit();
    v_pending = iv.slot;
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(acc);
  hp::fence_regs(pa);
  if (v_pending >= 0) hp::bar_arrive(&empty[v_pending]);

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const long q_row = (long)H * D;
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn) {
    const int col = 8 * jn + 2 * t;
    if (col >= D) continue;
    if (r0 < Tq)
      *reinterpret_cast<uint32_t*>(o + ((long)b * Tq + r0) * q_row +
                                   (long)h * D + col) =
          hp::pack_bf16(acc[4 * jn] / d0, acc[4 * jn + 1] / d0);
    if (r1 < Tq)
      *reinterpret_cast<uint32_t*>(o + ((long)b * Tq + r1) * q_row +
                                   (long)h * D + col) =
          hp::pack_bf16(acc[4 * jn + 2] / d1, acc[4 * jn + 3] / d1);
  }
  if (lse != nullptr && t == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    if (r0 < Tq) lse[((long)b * Tq + r0) * H + h] = (m0 + log2f(d0)) * LN2;
    if (r1 < Tq) lse[((long)b * Tq + r1) * H + h] = (m1 + log2f(d1)) * LN2;
  }
}

template <int DP, int NSLOT, int MINB>
int launch_hopper(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int Tq, int S, int H, int KV, int D,
                  int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = hp::make_map(&qm, q, B, Tq, H, D);
  if (err == 0) err = hp::make_map(&km, k, B, S, KV, D);
  if (err == 0) err = hp::make_map(&vm, v, B, S, KV, D);
  if (err != 0) return err;
  const int smem = FwdLayout<DP, NSLOT>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_hopper_kernel<DP, NSLOT, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return repro::refused(e);
  const dim3 grid((Tq + 63) / 64, H, B);
  // scale * log2(e) rounded once to f32, as kernels/ref.py rounds it
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  flash_fwd_hopper_kernel<DP, NSLOT, MINB><<<grid, 160, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      Tq, S, H, KV, D, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int Tq, int S, int H, int KV, int D,
                                   int causal, int window, int dtype,
                                   float scale, void* stream) {
  // the wrapper checks shapes; these guard the launch itself
  if (D % 8 != 0 || D > 256 || H % KV != 0 || Tq <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return launch_nj<float>(q, k, v, o, lse, B, Tq, S, H, KV, D, causal,
                            window, scale, st);
  if (dtype == repro::DTYPE_BF16 && D % 16 == 0 && D <= 128)
    return D <= 64 ? launch_hopper<64, 4, 4>(q, k, v, o, lse, B, Tq, S, H,
                                             KV, D, causal, window, scale,
                                             st)
                   : launch_hopper<128, 3, 3>(q, k, v, o, lse, B, Tq, S, H,
                                              KV, D, causal, window, scale,
                                              st);
  if (dtype == repro::DTYPE_BF16)
    return launch_nj<__nv_bfloat16>(q, k, v, o, lse, B, Tq, S, H, KV, D,
                                    causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
