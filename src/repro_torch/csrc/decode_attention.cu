// Single-token decode attention over a KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (`_decode_kernel`, launched by `decode_attention`). Same function: q
// [B,1,H,D], k/v [B,S,KV,D] (f32 or bf16, contiguous) -> o [B,1,H,D] in
// q's dtype, attending only the cache slots marked valid. Validity is
// data-dependent (empty ring slots, out-of-window and future positions), so
// it arrives as data: `valid` is a uint8 [B,S] array (a torch.bool tensor's
// bytes) and the kernel masks invalid slots itself, where the TPU kernel
// took an f32 additive bias of 0 / -1e30.
//
// What bounds it on the H100: it reads each cache byte once, 2 x 18 MB at
// the B=8, S=275, KV=32, D=128 bf16 shapes, ~10.8 us at 3.35 TB/s; its
// arithmetic is tiny. At the serving path's own shapes (cache of 20 slots)
// the launch itself dominates. It is called once per layer per decoded
// token (7 x 32 times per batch for openvla-7b).
//
// Design: one CTA per (kv head, batch row) serves all H / KV query heads
// that share that kv head, so K/V are read from device memory once (the
// reference's per-(b, h) program reads them once per query head). The TPU
// grid's sequential kv axis becomes a loop over 64-slot tiles staged in
// shared memory (f32), with an f32 online softmax; masked slots score -inf
// and contribute 0 while the running max keeps the finite NEG_INF sentinel.
// The cache is padded to no tile multiple: slots s >= S are masked here.

#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int DBK = 64;        // cache slots per tile (2 per lane)
constexpr int DTHREADS = 128;

size_t smem_bytes(int G, int D) {
  return sizeof(float) *
         ((size_t)G * D + (size_t)DBK * (D + 1) + (size_t)DBK * D +
          (size_t)G * DBK + (size_t)G * D + 3 * (size_t)G);
}

template <typename T>
__global__ void __launch_bounds__(DTHREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ valid,
              T* __restrict__ o, int S, int H, int KV, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / KV;
  const int DP = D + 1;              // padded K rows: conflict-free dots
  float* qs = smem;                  // [G][D]
  float* Ks = qs + G * D;            // [DBK][DP]
  float* Vs = Ks + DBK * DP;         // [DBK][D]
  float* Ps = Vs + DBK * D;          // [G][DBK] scores, then weights
  float* acc = Ps + G * DBK;         // [G][D]
  float* m_s = acc + G * D;          // [G]
  float* l_s = m_s + G;              // [G]
  float* c_s = l_s + G;              // [G]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nwarps = DTHREADS / 32;

  // the G query heads of this kv head are contiguous: h = kvh * G + g
  const long q_off = ((long)b * H + (long)kvh * G) * D;
  const long k_row = (long)KV * D;
  const T* kb = k + (long)b * S * k_row + (long)kvh * D;
  const T* vb = v + (long)b * S * k_row + (long)kvh * D;
  const uint8_t* valid_b = valid + (long)b * S;

  for (int idx = tid; idx < G * D; idx += DTHREADS) {
    qs[idx] = repro::to_f(q[q_off + idx]);
    acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += DTHREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += DBK) {
    // 8 elements per thread and step: one or two 16-byte loads
#pragma unroll 4
    for (int idx = tid; idx < DBK * (D / 8); idx += DTHREADS) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const int s = s0 + r;
      float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (s < S) {
        repro::load8(kb + s * k_row + c, kf);
        repro::load8(vb + s * k_row + c, vf);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        Ks[r * DP + c + i] = kf[i];
        Vs[r * D + c + i] = vf[i];
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * DBK; idx += DTHREADS) {
      const int g = idx / DBK, j = idx % DBK;
      const int s = s0 + j;
      float sc = -INFINITY;
      if (s < S && valid_b[s]) {
        const float* qg = qs + g * D;
        const float* kj = Ks + j * DP;
        // four partial sums (D is a multiple of 8) shorten the FMA chain
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
        for (int d = 0; d < D; d += 4) {
          d0 = fmaf(qg[d], kj[d], d0);
          d1 = fmaf(qg[d + 1], kj[d + 1], d1);
          d2 = fmaf(qg[d + 2], kj[d + 2], d2);
          d3 = fmaf(qg[d + 3], kj[d + 3], d3);
        }
        sc = ((d0 + d1) + (d2 + d3)) * scale;
      }
      Ps[idx] = sc;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float* pg = Ps + g * DBK;
      const float x0 = pg[lane], x1 = pg[lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, repro::warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float sum = repro::warp_sum(p0 + p1);
      pg[lane] = repro::round_to<T>(p0);
      pg[lane + 32] = repro::round_to<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * D; idx += DTHREADS) {
      const int g = idx / D, d = idx % D;
      const float* pg = Ps + g * DBK;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int j = 0; j < DBK; j += 4) {
        a0 = fmaf(pg[j], Vs[j * D + d], a0);
        a1 = fmaf(pg[j + 1], Vs[(j + 1) * D + d], a1);
        a2 = fmaf(pg[j + 2], Vs[(j + 2) * D + d], a2);
        a3 = fmaf(pg[j + 3], Vs[(j + 3) * D + d], a3);
      }
      acc[idx] = acc[idx] * c_s[g] + ((a0 + a1) + (a2 + a3));
    }
    __syncthreads();
  }

  for (int idx = tid; idx < G * D; idx += DTHREADS) {
    const int g = idx / D;
    o[q_off + idx] = repro::from_f<T>(acc[idx] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* o, int B, int S, int H, int KV, int D, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return repro::refused(err);
  const dim3 grid(KV, B);
  decode_kernel<T><<<grid, DTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(o), S, H, KV, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* valid, void* o,
                                    int B, int S, int H, int KV, int D,
                                    int dtype, float scale, void* stream) {
  if (D % 8 != 0 || D > 256 || H % KV != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return launch<float>(q, k, v, valid, o, B, S, H, KV, D, scale, st);
  if (dtype == repro::DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, valid, o, B, S, H, KV, D, scale,
                                 st);
  return (int)cudaErrorInvalidValue;
}
