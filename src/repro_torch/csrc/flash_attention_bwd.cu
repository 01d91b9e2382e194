// Causal (optionally sliding-window) GQA flash attention, backward (K3), for
// Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
// `_attn_bwd_dq_kernel` and `_attn_bwd_dkv_kernel`, launched by
// `flash_attention_bwd`. q, dO [B,T,H,D], k/v [B,S,KV,D] (f32 or bf16,
// contiguous), lse [B,T,H] f32 from the forward, dd = rowsum(dO o O) [B,T,H]
// f32 (one plain reduction outside, as the reference computes it outside
// Pallas) -> dq like q, dk/dv like k, accumulated in f32:
//   p = exp(q.k * scale - lse), ds = p o (dO.V^T - dd),
//   dq = ds.K * scale, dk = ds^T.Q * scale, dv = p^T.dO.
// The mask is the forward's (top-left causal, window, positions from 0).
// Rows qpos >= T and keys kpos >= S are masked here, with no host padding:
// a row past T contributes exactly 0 (the reference's _LSE_PAD property).
//
// What bounds it on the H100, at the training slice's shape (B = 36,
// T = S = 275, H = 32, D = 128, bf16): it reads q, k, v, o, dO and lse and
// writes dq, dk, dv (~650 MB, ~0.19 ms at 3.35 TB/s), and does five
// T x S x D products over the causal half (~57 GFLOP, ~57 us at 989 TFLOP/s
// on the tensor cores), so it is memory-bound.
//
// Design: two kernels, as the TPU has. dq: one CTA per (64-row q tile, head,
// batch) looping over the kv tiles the tile can see. dk/dv: one CTA per
// (64-key kv tile, kv head, batch) looping over the `group` q heads of its
// kv head and over the q tiles that see the kv tile, so GQA is folded inside
// the kernel: no per-q-head f32 [B,S,H,D] partials and no sum outside. The
// TPU's sequential grid axes become these in-CTA loops; every output element
// is summed by one thread in a fixed order (no atomics).
//
// Two bodies, chosen by what the inputs are, as in the forward: bf16 with
// D % 16 == 0 and D <= 128 (the training path) runs all five products on
// the tensor cores (mma.sync, 4 warps x 16 rows, 32-row steps; see the note
// above flash_bwd_dq_mma_kernel); f32, and bf16 heads of other widths, stage
// f32 tiles in shared memory and run the products as f32 FMAs (16 x 16
// threads, 4 x 4 micro-tiles), heads up to D = 128. wgmma/TMA and
// pipelined loads are later work.

#include "common.cuh"

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 256;  // 16 x 16 thread grid

__device__ __forceinline__ bool visible(int qpos, int kpos, int T, int S,
                                        int causal, int window) {
  bool ok = qpos < T && kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && (qpos - kpos) < window;
  return ok;
}

// rows [r0, r0 + 64) of a [.., L, heads, D] tensor at head `hh` into an f32
// tile [64][D + 4], zero past `L`
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ base, int r0,
                          int L, long row, int D) {
  const int DP = D + 4;
  for (int idx = threadIdx.x; idx < 64 * (D / 8); idx += NTHREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < L) repro::load8(base + (long)(r0 + r) * row + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * DP + c + i] = f[i];
  }
}

// a[i][j] += A[ty + 16 i] . B[tx + 16 j] and b[i][j] += C[ty+16i] . E[tx+16j]
// over D, for two pairs of [64][D + 4] tiles
__device__ __forceinline__ void two_score_tiles(
    float (&a)[4][4], float (&b)[4][4], const float* A, const float* Bm,
    const float* C, const float* E, int D, int tx, int ty) {
  const int DP = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 ra[4], rb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ra[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * DP + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      rb[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * DP + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = a[i][j];
        s = fmaf(ra[i].x, rb[j].x, s);
        s = fmaf(ra[i].y, rb[j].y, s);
        s = fmaf(ra[i].z, rb[j].z, s);
        s = fmaf(ra[i].w, rb[j].w, s);
        a[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ra[i] = *reinterpret_cast<const float4*>(&C[(ty + 16 * i) * DP + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      rb[j] = *reinterpret_cast<const float4*>(&E[(tx + 16 * j) * DP + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = b[i][j];
        s = fmaf(ra[i].x, rb[j].x, s);
        s = fmaf(ra[i].y, rb[j].y, s);
        s = fmaf(ra[i].z, rb[j].z, s);
        s = fmaf(ra[i].w, rb[j].w, s);
        b[i][j] = s;
      }
  }
}

// acc[i][j] += sum_c P[ty + 16 i][c] * X[c][tx + 16 j], P [64][65], X
// [64][D + 4]
template <int NJ>
__device__ __forceinline__ void accumulate_pv(float (&acc)[4][NJ],
                                              const float* P, const float* X,
                                              int D, int tx, int ty) {
  const int DP = D + 4;
  for (int c = 0; c < 64; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = P[(ty + 16 * i) * 65 + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      const float x = col < D ? X[c * DP + col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], x, acc[i][j]);
    }
  }
}

size_t dq_smem(int D) {
  return sizeof(float) * (4 * 64 * (size_t)(D + 4) + 64 * 65 + 2 * 64);
}
size_t dkv_smem(int D) {
  return sizeof(float) * (4 * 64 * (size_t)(D + 4) + 2 * 64 * 65 + 2 * 64);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, T* __restrict__ dq,
                    int Tq, int S, int H, int KV, int D, int causal,
                    int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 4;
  float* Qs = smem;                 // [BQ][DP]
  float* dOs = Qs + BQ * DP;        // [BQ][DP]
  float* Ks = dOs + BQ * DP;        // [BK][DP]
  float* Vs = Ks + BK * DP;         // [BK][DP]
  float* Ps = Vs + BK * DP;         // [BQ][65]: ds
  float* lse_s = Ps + BQ * 65;      // [BQ]
  float* dd_s = lse_s + BQ;         // [BQ]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long q_row = (long)H * D, k_row = (long)KV * D;
  const T* qb = q + (long)b * Tq * q_row + (long)h * D;
  const T* dob = dout + (long)b * Tq * q_row + (long)h * D;
  const T* kb = k + (long)b * S * k_row + (long)kvh * D;
  const T* vb = v + (long)b * S * k_row + (long)kvh * D;

  load_tile(Qs, qb, q0, Tq, q_row, D);
  load_tile(dOs, dob, q0, Tq, q_row, D);
  for (int r = tid; r < BQ; r += NTHREADS) {
    const bool in = q0 + r < Tq;
    const long i = ((long)b * Tq + q0 + r) * H + h;
    lse_s[r] = in ? lse[i] : 0.f;
    dd_s[r] = in ? dd[i] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_tile(Ks, kb, k0, S, k_row, D);
    load_tile(Vs, vb, k0, S, k_row, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_score_tiles(s, dp, Qs, Ks, dOs, Vs, D, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, Tq, S, causal, window)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.f;
        Ps[r * 65 + c] = p * (dp[i][j] - dd_s[r]);
      }
    __syncthreads();
    accumulate_pv<NJ>(acc, Ps, Ks, D, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Tq) continue;
    T* row = dq + ((long)b * Tq + qpos) * q_row + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) row[col] = repro::from_f<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int S, int H, int KV, int D,
                     int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 4;
  float* Ks = smem;                 // [BK][DP]
  float* Vs = Ks + BK * DP;         // [BK][DP]
  float* Qs = Vs + BK * DP;         // [BQ][DP]
  float* dOs = Qs + BQ * DP;        // [BQ][DP]
  float* PT = dOs + BQ * DP;        // [BK][65]: p^T
  float* DST = PT + BK * 65;        // [BK][65]: ds^T
  float* lse_s = DST + BK * 65;     // [BQ]
  float* dd_s = lse_s + BQ;         // [BQ]

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long q_row = (long)H * D, k_row = (long)KV * D;
  const T* kb = k + (long)b * S * k_row + (long)kvh * D;
  const T* vb = v + (long)b * S * k_row + (long)kvh * D;

  load_tile(Ks, kb, k0, S, k_row, D);
  load_tile(Vs, vb, k0, S, k_row, D);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // q tiles that can see this kv tile
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int q_end = window > 0 ? min(Tq, k0 + BK - 1 + window) : Tq;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const T* qb = q + (long)b * Tq * q_row + (long)h * D;
    const T* dob = dout + (long)b * Tq * q_row + (long)h * D;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();   // the previous tile's readers are done
      load_tile(Qs, qb, q0, Tq, q_row, D);
      load_tile(dOs, dob, q0, Tq, q_row, D);
      for (int r = tid; r < BQ; r += NTHREADS) {
        const bool in = q0 + r < Tq;
        const long i = ((long)b * Tq + q0 + r) * H + h;
        lse_s[r] = in ? lse[i] : 0.f;
        dd_s[r] = in ? dd[i] : 0.f;
      }
      __syncthreads();
      // rows: keys ty + 16 i; columns: queries tx + 16 j
      float st[4][4], dpt[4][4];
      two_score_tiles(st, dpt, Ks, Qs, Vs, dOs, D, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float p = visible(q0 + c, k0 + r, Tq, S, causal, window)
                              ? expf(st[i][j] * scale - lse_s[c])
                              : 0.f;
          PT[r * 65 + c] = p;
          DST[r * 65 + c] = p * (dpt[i][j] - dd_s[c]);
        }
      __syncthreads();
      accumulate_pv<NJ>(dv_acc, PT, dOs, D, tx, ty);
      accumulate_pv<NJ>(dk_acc, DST, Qs, D, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= S) continue;
    const long off = ((long)b * S + kpos) * k_row + (long)kvh * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) {
        dk[off + col] = repro::from_f<T>(dk_acc[i][j] * scale);
        dv[off + col] = repro::from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dd, void* dq, void* dk, void* dv,
           int B, int Tq, int S, int H, int KV, int D, int causal, int window,
           float scale, cudaStream_t st) {
  const size_t s1 = dq_smem(D), s2 = dkv_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (err != cudaSuccess) return repro::refused(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return repro::refused(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* ddp = static_cast<const float*>(dd);
  flash_bwd_dq_kernel<T, NJ><<<dim3((Tq + BQ - 1) / BQ, H, B), NTHREADS, s1,
                               st>>>(qp, kp, vp, dop, lp, ddp,
                                     static_cast<T*>(dq), Tq, S, H, KV, D,
                                     causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, NJ><<<dim3((S + BK - 1) / BK, KV, B), NTHREADS, s2,
                                st>>>(qp, kp, vp, dop, lp, ddp,
                                      static_cast<T*>(dk),
                                      static_cast<T*>(dv), Tq, S, H, KV, D,
                                      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nj(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dd, void* dq, void* dk, void* dv,
              int B, int Tq, int S, int H, int KV, int D, int causal,
              int window, float scale, cudaStream_t st) {
#define REPRO_NJ(n)                                                        \
  case n:                                                                  \
    return launch<T, n>(q, k, v, dout, lse, dd, dq, dk, dv, B, Tq, S, H,   \
                        KV, D, causal, window, scale, st);
  switch ((D + 15) / 16) {
    REPRO_NJ(1) REPRO_NJ(2) REPRO_NJ(3) REPRO_NJ(4)
    REPRO_NJ(5) REPRO_NJ(6) REPRO_NJ(7) REPRO_NJ(8)
  }
#undef REPRO_NJ
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// bf16 with D a multiple of 16 up to 128 (the training path: D = 128): every
// product runs on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate), 4 warps of 16 rows each. q, k, v and dO are bf16 already, so
// S = Q K^T and dP = dO V^T are exact products summed in f32, as in the FMA
// body. P and dS are f32; to keep that precision through the second
// products (the reference computes them in f32), each is split as
// hi + lo with hi = bf16(x), lo = bf16(x - hi) and multiplied twice, which
// leaves a relative error of ~2^-16 instead of bf16's 2^-8. The B operands
// of the second products (K, Q, dO staged row-major) come transposed
// through ldmatrix, as V's do in the forward.
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 rows
constexpr int MMA_ROWS = 64;       // rows of the CTA's own operand
constexpr int MMA_TILE = 32;       // keys (dq) or queries (dk/dv) per step

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

// x = hi + lo in bf16 pairs: the high parts, and the rounding remainders
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
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

// shared memory of either tensor-core kernel: two [64, D + 8] and two
// [32, D + 8] bf16 tiles (rows padded for conflict-free fragments), and the
// dk/dv kernel's 32 lse and dd values
size_t mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) * (2 * MMA_ROWS + 2 * MMA_TILE) * (D + 8) +
         sizeof(float) * 2 * MMA_TILE;
}

// rows [r0, r0 + n) of a [.., L, heads, D] bf16 tensor into smem rows of
// stride KS, zero past L
template <int D, int KS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* base, int r0,
                                           int n, int L, long row) {
  for (int idx = threadIdx.x; idx < n * (D / 8); idx += MMA_THREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L)
      u = *reinterpret_cast<const uint4*>(base + (long)(r0 + r) * row + c);
    *reinterpret_cast<uint4*>(&dst[r * KS + c]) = u;
  }
}

// c[n] (n < 4: 32 columns) = A(16 rows of smem `a` at row a0) . B(rows of
// smem `b`)^T over D, both row-major with stride KS
template <int KD, int KS>
__device__ __forceinline__ void scores16x32(float (&c)[4][4],
                                            const __nv_bfloat16* a, int a0,
                                            const __nv_bfloat16* b, int g,
                                            int t) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int col = kk * 16 + 2 * t;
    uint32_t fa[4];
    fa[0] = ld32(&a[(a0 + g) * KS + col]);
    fa[1] = ld32(&a[(a0 + g + 8) * KS + col]);
    fa[2] = ld32(&a[(a0 + g) * KS + col + 8]);
    fa[3] = ld32(&a[(a0 + g + 8) * KS + col + 8]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const __nv_bfloat16* bp = &b[(n * 8 + g) * KS + col];
      mma_bf16(c[n], fa, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[dn] += X(16 x 32, f32 accumulators in c) . Y(32 rows of smem y), with
// X split hi + lo
template <int KD, int KS>
__device__ __forceinline__ void accumulate_split(float (&acc)[2 * KD][4],
                                                 const float (&x)[4][4],
                                                 const __nv_bfloat16* y,
                                                 int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {         // k16 chunks of the 32 columns
    uint32_t hi[4], lo[4];
    split_pack(x[2 * j][0], x[2 * j][1], hi[0], lo[0]);
    split_pack(x[2 * j][2], x[2 * j][3], hi[1], lo[1]);
    split_pack(x[2 * j + 1][0], x[2 * j + 1][1], hi[2], lo[2]);
    split_pack(x[2 * j + 1][2], x[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dn = 0; dn < 2 * KD; ++dn) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, &y[(j * 16 + lane % 16) * KS + dn * 8]);
      mma_bf16(acc[dn], hi, b0, b1);
      mma_bf16(acc[dn], lo, b0, b1);
    }
  }
}

template <int KD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dd,
                        __nv_bfloat16* __restrict__ dq, int Tq, int S, int H,
                        int KV, int causal, int window, float scale) {
  constexpr int D = KD * 16;
  constexpr int KS = D + 8;     // padded rows: conflict-free fragments
  extern __shared__ uint4 mma_smem[];       // mma_smem_bytes(D) bytes
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* dOs = Qs + MMA_ROWS * KS;
  __nv_bfloat16* Ks = dOs + MMA_ROWS * KS;
  __nv_bfloat16* Vs = Ks + MMA_TILE * KS;

  const int q0 = blockIdx.x * MMA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long q_row = (long)H * D, k_row = (long)KV * D;
  const __nv_bfloat16* kb = k + (long)b * S * k_row + (long)kvh * D;
  const __nv_bfloat16* vb = v + (long)b * S * k_row + (long)kvh * D;
  stage_rows<D, KS>(Qs, q + (long)b * Tq * q_row + (long)h * D, q0, MMA_ROWS,
                    Tq, q_row);
  stage_rows<D, KS>(dOs, dout + (long)b * Tq * q_row + (long)h * D, q0,
                    MMA_ROWS, Tq, q_row);

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long i0 = ((long)b * Tq + r0) * H + h, i1 = i0 + 8L * H;
  const float lse0 = r0 < Tq ? lse[i0] : 0.f, lse1 = r1 < Tq ? lse[i1] : 0.f;
  const float dd0 = r0 < Tq ? dd[i0] : 0.f, dd1 = r1 < Tq ? dd[i1] : 0.f;

  float acc[2 * KD][4];
#pragma unroll
  for (int dn = 0; dn < 2 * KD; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int q_last = min(q0 + MMA_ROWS, Tq) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / MMA_TILE) * MMA_TILE;

  for (int k0 = k_begin; k0 < k_end; k0 += MMA_TILE) {
    __syncthreads();        // Q/dO staged; the previous tile's readers done
    stage_rows<D, KS>(Ks, kb, k0, MMA_TILE, S, k_row);
    stage_rows<D, KS>(Vs, vb, k0, MMA_TILE, S, k_row);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores16x32<KD, KS>(s, Qs, warp * 16, Ks, g, t);
    scores16x32<KD, KS>(dp, dOs, warp * 16, Vs, g, t);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float p = visible(row, key, Tq, S, causal, window)
                            ? expf(s[n][e] * scale - (e < 2 ? lse0 : lse1))
                            : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? dd0 : dd1));      // ds
      }
    accumulate_split<KD, KS>(acc, s, Ks, lane);
  }

#pragma unroll
  for (int dn = 0; dn < 2 * KD; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r0 < Tq)
      *reinterpret_cast<uint32_t*>(dq + ((long)b * Tq + r0) * q_row +
                                   (long)h * D + col) =
          pack_bf16(acc[dn][0] * scale, acc[dn][1] * scale);
    if (r1 < Tq)
      *reinterpret_cast<uint32_t*>(dq + ((long)b * Tq + r1) * q_row +
                                   (long)h * D + col) =
          pack_bf16(acc[dn][2] * scale, acc[dn][3] * scale);
  }
}

template <int KD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Tq, int S, int H,
                         int KV, int causal, int window, float scale) {
  constexpr int D = KD * 16;
  constexpr int KS = D + 8;
  extern __shared__ uint4 mma_smem[];       // mma_smem_bytes(D) bytes
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* Vs = Ks + MMA_ROWS * KS;
  __nv_bfloat16* Qs = Vs + MMA_ROWS * KS;
  __nv_bfloat16* dOs = Qs + MMA_TILE * KS;
  float* lse_s = reinterpret_cast<float*>(dOs + MMA_TILE * KS);
  float* dd_s = lse_s + MMA_TILE;

  const int k0 = blockIdx.x * MMA_ROWS, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long q_row = (long)H * D, k_row = (long)KV * D;
  stage_rows<D, KS>(Ks, k + (long)b * S * k_row + (long)kvh * D, k0,
                    MMA_ROWS, S, k_row);
  stage_rows<D, KS>(Vs, v + (long)b * S * k_row + (long)kvh * D, k0,
                    MMA_ROWS, S, k_row);

  float dk_acc[2 * KD][4], dv_acc[2 * KD][4];
#pragma unroll
  for (int dn = 0; dn < 2 * KD; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;   // this thread's keys
  const int q_begin = causal ? (k0 / MMA_TILE) * MMA_TILE : 0;
  const int q_end = window > 0 ? min(Tq, k0 + MMA_ROWS - 1 + window) : Tq;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const __nv_bfloat16* qb = q + (long)b * Tq * q_row + (long)h * D;
    const __nv_bfloat16* dob = dout + (long)b * Tq * q_row + (long)h * D;
    for (int q0 = q_begin; q0 < q_end; q0 += MMA_TILE) {
      __syncthreads();      // the previous tile's readers are done
      stage_rows<D, KS>(Qs, qb, q0, MMA_TILE, Tq, q_row);
      stage_rows<D, KS>(dOs, dob, q0, MMA_TILE, Tq, q_row);
      for (int r = threadIdx.x; r < MMA_TILE; r += MMA_THREADS) {
        const bool in = q0 + r < Tq;
        const long i = ((long)b * Tq + q0 + r) * H + h;
        lse_s[r] = in ? lse[i] : 0.f;
        dd_s[r] = in ? dd[i] : 0.f;
      }
      __syncthreads();
      // rows: keys; columns: queries
      float st[4][4], dpt[4][4];
      scores16x32<KD, KS>(st, Ks, warp * 16, Qs, g, t);
      scores16x32<KD, KS>(dpt, Vs, warp * 16, dOs, g, t);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? kr0 : kr1;
          const int c = n * 8 + 2 * t + (e & 1);
          const float p = visible(q0 + c, key, Tq, S, causal, window)
                              ? expf(st[n][e] * scale - lse_s[c])
                              : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dd_s[c]);           // ds^T
        }
      accumulate_split<KD, KS>(dv_acc, st, dOs, lane);
      accumulate_split<KD, KS>(dk_acc, dpt, Qs, lane);
    }
  }

#pragma unroll
  for (int dn = 0; dn < 2 * KD; ++dn) {
    const int col = dn * 8 + 2 * t;
    const long o0 = ((long)b * S + kr0) * k_row + (long)kvh * D + col;
    const long o1 = o0 + 8 * k_row;
    if (kr0 < S) {
      *reinterpret_cast<uint32_t*>(dk + o0) =
          pack_bf16(dk_acc[dn][0] * scale, dk_acc[dn][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o0) =
          pack_bf16(dv_acc[dn][0], dv_acc[dn][1]);
    }
    if (kr1 < S) {
      *reinterpret_cast<uint32_t*>(dk + o1) =
          pack_bf16(dk_acc[dn][2] * scale, dk_acc[dn][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o1) =
          pack_bf16(dv_acc[dn][2], dv_acc[dn][3]);
    }
  }
}

template <int KD>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dd, void* dq, void* dk, void* dv,
               int B, int Tq, int S, int H, int KV, int causal, int window,
               float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const int smem = (int)mma_smem_bytes(KD * 16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<KD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return repro::refused(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<KD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return repro::refused(err);
  flash_bwd_dq_mma_kernel<KD>
      <<<dim3((Tq + MMA_ROWS - 1) / MMA_ROWS, H, B), MMA_THREADS, smem,
         st>>>(
          static_cast<const bf*>(q), static_cast<const bf*>(k),
          static_cast<const bf*>(v), static_cast<const bf*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(dd),
          static_cast<bf*>(dq), Tq, S, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_mma_kernel<KD>
      <<<dim3((S + MMA_ROWS - 1) / MMA_ROWS, KV, B), MMA_THREADS, smem,
         st>>>(
          static_cast<const bf*>(q), static_cast<const bf*>(k),
          static_cast<const bf*>(v), static_cast<const bf*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(dd),
          static_cast<bf*>(dk), static_cast<bf*>(dv), Tq, S, H, KV, causal,
          window, scale);
  return (int)cudaGetLastError();
}

int launch_mma_kd(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dd, void* dq,
                  void* dk, void* dv, int B, int Tq, int S, int H, int KV,
                  int D, int causal, int window, float scale,
                  cudaStream_t st) {
#define REPRO_KD(n)                                                         \
  case n:                                                                   \
    return launch_mma<n>(q, k, v, dout, lse, dd, dq, dk, dv, B, Tq, S, H,   \
                         KV, causal, window, scale, st);
  switch (D / 16) {
    REPRO_KD(1) REPRO_KD(2) REPRO_KD(3) REPRO_KD(4)
    REPRO_KD(5) REPRO_KD(6) REPRO_KD(7) REPRO_KD(8)
  }
#undef REPRO_KD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dd, void* dq,
                                   void* dk, void* dv, int B, int Tq, int S,
                                   int H, int KV, int D, int causal,
                                   int window, int dtype, float scale,
                                   void* stream) {
  // the wrapper checks shapes; these guard the launch itself
  if (D % 8 != 0 || D > 128 || KV <= 0 || H % KV != 0 || Tq <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return launch_nj<float>(q, k, v, dout, lse, dd, dq, dk, dv, B, Tq, S, H,
                            KV, D, causal, window, scale, st);
  if (dtype == repro::DTYPE_BF16 && D % 16 == 0)
    return launch_mma_kd(q, k, v, dout, lse, dd, dq, dk, dv, B, Tq, S, H, KV,
                         D, causal, window, scale, st);
  if (dtype == repro::DTYPE_BF16)
    return launch_nj<__nv_bfloat16>(q, k, v, dout, lse, dd, dq, dk, dv, B,
                                    Tq, S, H, KV, D, causal, window, scale,
                                    st);
  return (int)cudaErrorInvalidValue;
}
