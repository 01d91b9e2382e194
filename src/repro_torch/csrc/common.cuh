// Shared device helpers for the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

// Finite sentinel for the running max m, as in the reference kernels: a
// row that has seen no valid key keeps m = NEG_INF (finite), so
// exp(m_old - m_new) never becomes exp(-inf + inf) = NaN.
constexpr float NEG_INF = -1e30f;

// dtype codes shared with the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// A refused runtime call (cudaFuncSetAttribute asking for more shared
// memory than the card has) also sets the runtime's last error: clear it, or
// the next launch's cudaGetLastError() reports it against that kernel.
inline int refused(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Softmax weights are rounded to the value type before the PV product, as
// the reference kernel does (p.astype(v.dtype)).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Eight consecutive elements as f32, in one 16-byte load for bf16 or two
// for f32: `p` must be 16-byte aligned (the wrappers check the bases, and
// every offset used is a multiple of 8 elements).
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows x cols elements into shared memory (row stride dst_stride), 16 bytes
// a thread: the first `valid` rows from global (row stride src_stride), the
// rest zeros (the padding of a sequence's short last chunk)
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dst_stride,
                                          const T* src, long src_stride,
                                          int rows, int valid, int cols,
                                          int nt) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = cols / V;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += nt) {
    const int r = idx / per_row, c = (idx - r * per_row) * V;
    *reinterpret_cast<uint4*>(dst + (size_t)r * dst_stride + c) =
        r < valid
            ? *reinterpret_cast<const uint4*>(src + (size_t)r * src_stride + c)
            : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The shapes the SSD scan kernels (K6, K7) take: chunks of a multiple of
// 32 steps (the last one of a sequence may be short), P and N multiples of
// 8.
inline bool bad_ssd_shape(int Bsz, int Lseq, int H, int P, int N, int q) {
  return Bsz < 1 || H < 1 || Lseq < 1 || q < 32 || q % 32 || P < 8
         || P % 8 || N < 8 || N % 8;
}

// Inclusive cumsum of dtv * a over q (a multiple of 32) values; warp 0 only.
__device__ __forceinline__ void chunk_cumsum(const float* dtv, float a,
                                             float* cum, int q) {
  const int lane = threadIdx.x & 31;
  const int per = q / 32;
  float run = 0.f;
  for (int k = 0; k < per; ++k) {
    run += dtv[lane * per + k] * a;
    cum[lane * per + k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) prev = 0.f;
  for (int k = 0; k < per; ++k) cum[lane * per + k] += prev;
}

}  // namespace repro
