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
// T=S=268, H=32, D=128, bf16) it moves ~70 MB (q, k, v, o once each) and
// does ~4.7 GFLOP of causal work, so the memory bound (~21 us at 3.35 TB/s)
// is above the tensor-core bound (~5 us at 989 TFLOP/s).
//
// Design: one CTA per (q-tile of 64 rows, head, batch). The TPU grid's
// sequential kv axis becomes a loop inside the CTA over 64-key tiles staged
// in shared memory, with an f32 online softmax and f32 accumulator. The CTA
// reads its K/V head h / (H / KV) directly: no KV duplication. Tiles fully
// above the causal diagonal or before the window start are skipped; the
// ragged edges are masked here (kpos < S for keys, no store for qpos >= T)
// instead of padding on the host. Masked scores are -inf, so they
// contribute exp(-inf) = 0 while m keeps the finite NEG_INF sentinel.
//
// Two bodies, chosen by what the inputs are: bf16 with D % 16 == 0 and
// D <= 128 (the serving path) runs both products on the tensor cores with
// mma.sync (flash_fwd_mma_kernel); f32, and bf16 heads outside that range,
// run them as f32 FMAs out of shared memory (flash_fwd_kernel), which is
// limited by shared-memory bandwidth and FMA issue. wgmma/TMA, and keeping
// the working set in bf16 for fewer bytes, are later work.

#include "common.cuh"

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
  if (err != cudaSuccess) return (int)err;
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
// bf16 with D a multiple of 16 up to 128 (the serving path: D = 128): the two
// products run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate). 4 warps per CTA, each owning 16 query rows of the 64-row
// tile; Q stays in registers as A fragments, K and V are staged in shared
// memory row-major; K's B fragments are 32-bit loads, V's come transposed
// through ldmatrix. The score accumulators are rescaled, masked and
// exponentiated in registers and repacked directly as the A fragments of
// the P V product.
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;       // 4 warps x 16 query rows
constexpr int MMA_BK = 64;       // keys per tile (8 n-tiles of the S product)
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two transposed 8x8 bf16 tiles from shared memory (rows addressed by lanes
// 0-15): the B fragment of an m16n8k16 product whose k axis runs along the
// stored rows, here V's keys.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

template <int KD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int Tq, int S, int H, int KV, int causal, int window,
                     float scale) {
  constexpr int D = KD * 16;
  // K and V tiles row-major with rows padded to D + 8: the 32-bit K loads
  // and the V ldmatrix rows then fall in distinct banks
  constexpr int KS = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[MMA_BK * KS];
  __shared__ __align__(16) __nv_bfloat16 Vs[MMA_BK * KS];

  const int q0 = blockIdx.x * MMA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // mma group / thread in group

  const long q_row = (long)H * D;
  const long k_row = (long)KV * D;
  const __nv_bfloat16* qb = q + (long)b * Tq * q_row + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * S * k_row + (long)kvh * D;
  const __nv_bfloat16* vb = v + (long)b * S * k_row + (long)kvh * D;

  // this thread's two rows of the fragments: r0 and r0 + 8
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < Tq ? ld32(qb + r0 * q_row + c) : 0u;
    qa[kk][1] = r1 < Tq ? ld32(qb + r1 * q_row + c) : 0u;
    qa[kk][2] = r0 < Tq ? ld32(qb + r0 * q_row + c + 8) : 0u;
    qa[kk][3] = r1 < Tq ? ld32(qb + r1 * q_row + c + 8) : 0u;
  }

  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const int q_last = min(q0 + MMA_BQ, Tq) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / MMA_BK) * MMA_BK;

  for (int k0 = k_begin; k0 < k_end; k0 += MMA_BK) {
#pragma unroll
    for (int it = 0; it < MMA_BK * (D / 8) / MMA_THREADS; ++it) {
      const int idx = tid + it * MMA_THREADS;
      const int row = idx / (D / 8), ch = idx % (D / 8);
      const int kpos = k0 + row;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 kv8 = kpos < S ? *reinterpret_cast<const uint4*>(
                                       kb + kpos * k_row + ch * 8)
                                 : zero;
      const uint4 vv8 = kpos < S ? *reinterpret_cast<const uint4*>(
                                       vb + kpos * k_row + ch * 8)
                                 : zero;
      *reinterpret_cast<uint4*>(&Ks[row * KS + ch * 8]) = kv8;
      *reinterpret_cast<uint4*>(&Vs[row * KS + ch * 8]) = vv8;
    }
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys
    float sc[MMA_BK / 8][4];
#pragma unroll
    for (int n = 0; n < MMA_BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* kp = &Ks[(n * 8 + g) * KS + kk * 16 + 2 * t];
        mma_bf16(sc[n], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < MMA_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        bool ok = key < S;
        if (causal) ok = ok && key <= row;
        if (window > 0) ok = ok && (row - key) < window;
        const float s = ok ? sc[n][e] * scale : -INFINITY;
        sc[n][e] = s;
        if (e < 2) mx0 = fmaxf(mx0, s); else mx1 = fmaxf(mx1, s);
      }
    // the four threads of a group hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);

    // P (rounded to bf16) as the A fragments of the P V product
    uint32_t pa[MMA_BK / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < MMA_BK / 8; ++n) {
      const float p0 = expf(sc[n][0] - mn0), p1 = expf(sc[n][1] - mn0);
      const float p2 = expf(sc[n][2] - mn1), p3 = expf(sc[n][3] - mn1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
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
    for (int dn = 0; dn < 2 * KD; ++dn) {
      acc[dn][0] *= corr0;
      acc[dn][1] *= corr0;
      acc[dn][2] *= corr1;
      acc[dn][3] *= corr1;
#pragma unroll
      for (int j = 0; j < MMA_BK / 16; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &Vs[(j * 16 + lane % 16) * KS + dn * 8]);
        mma_bf16(acc[dn], pa[j], b0, b1);
      }
    }
    __syncthreads();
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < 2 * KD; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r0 < Tq)
      *reinterpret_cast<uint32_t*>(o + ((long)b * Tq + r0) * q_row +
                                   (long)h * D + col) =
          pack_bf16(acc[dn][0] / d0, acc[dn][1] / d0);
    if (r1 < Tq)
      *reinterpret_cast<uint32_t*>(o + ((long)b * Tq + r1) * q_row +
                                   (long)h * D + col) =
          pack_bf16(acc[dn][2] / d1, acc[dn][3] / d1);
  }
  if (lse != nullptr && t == 0) {
    if (r0 < Tq) lse[((long)b * Tq + r0) * H + h] = m0 + logf(d0);
    if (r1 < Tq) lse[((long)b * Tq + r1) * H + h] = m1 + logf(d1);
  }
}

template <int KD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Tq, int S, int H, int KV, int causal,
               int window, float scale, cudaStream_t stream) {
  const dim3 grid((Tq + MMA_BQ - 1) / MMA_BQ, H, B);
  flash_fwd_mma_kernel<KD><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Tq, S, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_mma_kd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int Tq, int S, int H, int KV, int D,
                  int causal, int window, float scale, cudaStream_t stream) {
#define REPRO_KD(n)                                                          \
  case n:                                                                    \
    return launch_mma<n>(q, k, v, o, lse, B, Tq, S, H, KV, causal, window,   \
                         scale, stream);
  switch (D / 16) {
    REPRO_KD(1) REPRO_KD(2) REPRO_KD(3) REPRO_KD(4)
    REPRO_KD(5) REPRO_KD(6) REPRO_KD(7) REPRO_KD(8)
  }
#undef REPRO_KD
  return (int)cudaErrorInvalidValue;
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
    return launch_mma_kd(q, k, v, o, lse, B, Tq, S, H, KV, D, causal, window,
                         scale, st);
  if (dtype == repro::DTYPE_BF16)
    return launch_nj<__nv_bfloat16>(q, k, v, o, lse, B, Tq, S, H, KV, D,
                                    causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
