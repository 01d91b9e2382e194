// Hopper (sm_90a) primitives shared by the kernels: TMA tensor maps and
// loads, mbarrier rings, wgmma descriptors and instructions, register
// reallocation (K1, K3); thread-block cluster barriers and distributed
// shared memory (K2, K4); 2-D TMA boxes and programmatic dependent launch
// (K4); cp.async (K2, K7); ldmatrix and mma.sync with f32 operands split
// into bf16 terms (K4, K7).
//
// Every operand tile lives in shared memory as TMA leaves it with
// SWIZZLE_128B: a box of 64 rows x 64 bf16 (128 bytes a row), rows grouped
// in 1024-byte atoms of 8, the 16-byte chunks of row r permuted by r % 8.
// A head of D = 128 is two such boxes one after the other ("column
// chunks", 64 columns each, 8 KB apart). The same bytes serve
// wgmma in two ways:
//  - K-major (rows are M or N, the 64 columns the reduction axis k):
//    Q and K in S = Q K^T. The descriptor of k-step kk starts 32 bytes
//    (16 columns) further into the chunk, SBO = 1024 (the next 8 rows).
//  - MN-major (rows are the reduction axis k, columns N): V in O += P V,
//    and K, Q, dO as the B operands of dq, dk, dv. Read through wgmma's
//    transpose bit; the descriptor of k-step kk starts 16 rows (2048
//    bytes) further, SBO = 1024 (the next 8 rows of k), LBO = the distance
//    to the next column chunk (the next 64 values of N).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the
                    // runtime's driver entry point, so nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace hopper {

constexpr int TILE_ROWS = 64;            // rows of every TMA box
constexpr int CHUNK_COLS = 64;           // bf16 columns of one 128-byte row
constexpr int CHUNK_BYTES = TILE_ROWS * CHUNK_COLS * 2;   // 8 KB

// ---------------------------------------------------------------------------
// Host: one 4-D tensor map over a [Bsz, L, heads, D] bf16 tensor (contiguous),
// with a box of [1, 64 rows, 1, 64 columns] and 128-byte swizzle. Rows past L
// and columns past D come in as zeros (TMA's out-of-bounds fill), which is
// how the kernels take ragged T and S and heads narrower than 64.
// ---------------------------------------------------------------------------

using EncodeTiledFn = decltype(&cuTensorMapEncodeTiled);

inline EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
    cudaGetLastError();
  }
  return fn;
}

// 0 on success, else a CUDA runtime error code for the wrapper to report
inline int make_map(CUtensorMap* map, const void* base, int Bsz, int L,
                    int heads, int D) {
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)L, (cuuint64_t)Bsz};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)L * heads * D * 2};
  const cuuint32_t box[4] = {CHUNK_COLS, 1, TILE_ROWS, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 2-D map over a [rows, cols] tensor (contiguous rows, 16-byte aligned)
// of bf16 or f32, with a box of [box_rows, box_cols]: 128-byte swizzle for
// a box row of 128 bytes (bf16, 64 columns), none otherwise. Rows and
// columns past the tensor come in as zeros.
inline int make_map_2d(CUtensorMap* map, const void* base, bool f32,
                       long rows, long cols, int box_rows, int box_cols) {
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int esize = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = enc(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols * esize == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Device: shared-memory addresses, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the producer's arrival, announcing the bytes its copies will deliver
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the phase of parity `parity` to complete
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of a 4-D map: columns c0.., head h, rows r0.., batch b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h, int r0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(h), "r"(r0), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// one box of a 2-D map: columns c0.., rows r0..
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned at both ends) of global memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the 64-row boxes covering columns [0, DP) of rows r0.. into consecutive
// column chunks at dst
template <int DP>
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int r0, int b) {
#pragma unroll
  for (int c = 0; c < DP / CHUNK_COLS; ++c)
    tma_load(static_cast<char*>(dst) + c * CHUNK_BYTES, map, bar,
             c * CHUNK_COLS, h, r0, b);
}

// dynamic shared memory rounded up to the 1024-byte alignment of the
// swizzle atoms (kernels ask for 1 KB of slack)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// register reallocation between warpgroups (every warp of the group)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a named barrier among `n` threads (ids 1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// a shared-memory matrix descriptor for a 128-byte-swizzled tile at p
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// k-step kk (16 columns) of a K-major tile of 64-row column chunks
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return desc(static_cast<const char*>(tile) + (kk / 4) * CHUNK_BYTES +
                  (kk % 4) * 32,
              16, 1024);
}

// k-step kk (16 rows) of an MN-major tile of 64-row column chunks
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return desc(static_cast<const char*>(tile) + kk * 16 * 128, CHUNK_BYTES,
              1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulators across an
// asynchronous wgmma's issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// The three wgmma shapes the kernels use, one k-step (16) each, f32
// accumulators in the layout noted under "Fragments" below.
// d[32] (+)= A(smem desc, 64 x 16) . B(smem desc, 64 x 16)^T, both K-major:
// the score tiles (`accumulate` 0 starts them from zero)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] += A(registers, 64 x 16) . B(smem desc, 16 x 64): a head of
// D <= 64; B stored MN-major (its rows run along k), read through the
// transpose bit
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += the same with B 16 x 128: a head of D <= 128
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// ---------------------------------------------------------------------------
// Fragments. A warpgroup's m64nN f32 accumulator: warp w, lane (g = lane / 4,
// t = lane % 4) holds, for each 8-column block j, d[4j + e] at row
// 16 w + g + 8 (e / 2), column 8 j + 2 t + (e % 2). The A operand of a
// register wgmma (k-step kk, 16 columns) is the same layout packed as bf16
// pairs: blocks 2 kk and 2 kk + 1.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments of k-step kk from 32 accumulator values (64 columns)
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&x)[32],
                                       int kk) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// x = hi + lo, both as A fragments of k-step kk: hi = bf16(x), lo =
// bf16(x - hi), which keeps ~16 bits of x through a bf16 product
__device__ __forceinline__ void a_frag_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&x)[32], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = x[8 * kk + 2 * i], x1 = x[8 * kk + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x0 - hf.x, x1 - hf.y);
  }
}


// ---------------------------------------------------------------------------
// Thread-block clusters: barrier, distributed shared memory
// ---------------------------------------------------------------------------

// every thread of every CTA of the cluster; orders shared-memory writes
// before it against reads after it across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the f32 at `p` (this CTA's shared memory) in the shared memory of the
// cluster's CTA `rank`
__device__ __forceinline__ float ld_dsmem(const float* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

// the cluster barrier in halves: arrive (no ordering) as a CTA starts, and
// wait before its first access to another rank's shared memory, which is
// then known to have started
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// store f32 values at `p` (this CTA's shared memory, 8- or 16-byte
// aligned) into the shared memory of the cluster's CTA `rank`; visible
// there after the next cluster_sync
__device__ __forceinline__ void st_dsmem2(float* p, uint32_t rank,
                                          float2 v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
               "f"(v.x), "f"(v.y)
               : "memory");
}
__device__ __forceinline__ void st_dsmem4(float* p, uint32_t rank,
                                          float4 v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// programmatic dependent launch: a primary grid lets its dependent grid be
// launched (every CTA, once its own work no longer needs the SMs to
// itself), and the dependent waits for the primary's completion and memory
// before reading what it wrote
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// cp.async (16 bytes a thread; `pred` false fills the 16 bytes with zeros)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 (bf16 in, f32 accumulate) and its fragments. Lane l,
// g = l / 4, t = l % 4. A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1
// (row g + 8, k 2t..), a2 (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..).
// B (16 x 8): b0 (k 2t..2t+1, column g), b1 (k 2t + 8.., column g). C (16 x
// 8, f32): c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8, the same).
// The C fragments of two neighbouring n8 tiles are the A fragment of one
// k16 step (a0 = c[0][0..1], a1 = c[0][2..3], a2 = c[1][0..1], a3 = c[1][2..3]).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lanes 8m..8m+7 give the row addresses of m
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Lane offsets (row, column) into a row-major bf16 tile for ldsm4 / ldsm4_t:
//  frag_a:   the A fragment of the 16 x 16 block at (r0, c0), non-trans.
//  frag_a_t: the A fragment of the TRANSPOSE of the block stored at
//            (k0 rows, m0 columns), trans: A[m][k] = X[k][m].
//  frag_b:   B fragments of two n8 tiles (regs 0, 1: columns n0..n0+7; 2,
//            3: n0+8..) x k16, from a tile stored [n][k], non-trans.
//  frag_b_t: the same from a tile stored [k][n], trans.
struct Lane {
  int a_r, a_c, at_k, at_m, b_n, b_k, bt_k, bt_n;
  __device__ __forceinline__ explicit Lane(int l) {
    a_r = (l & 7) + ((l >> 3) & 1) * 8;
    a_c = (l >> 4) * 8;
    at_k = (l & 7) + (l >> 4) * 8;
    at_m = ((l >> 3) & 1) * 8;
    b_n = (l & 7) + (l >> 4) * 8;
    b_k = ((l >> 3) & 1) * 8;
    bt_k = (l & 7) + ((l >> 3) & 1) * 8;
    bt_n = (l >> 4) * 8;
  }
};

// (x0, x1) as bf16 pairs hi = bf16(x), lo = bf16(x - hi): a product with
// hi + lo keeps ~16 bits of x
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// (x0, x1) as three bf16 pairs, hi + mid + lo: ~24 bits of x, an f32
// operand's precision through bf16 products
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(r0 - mf.x, r1 - mf.y);
}

// the hi, mid and lo A fragments of the 16 x 16 block held as C fragments
// of two n8 tiles
__device__ __forceinline__ void a_split3(uint32_t (&hi)[4], uint32_t (&mid)[4],
                                         uint32_t (&lo)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  split3(c0[0], c0[1], hi[0], mid[0], lo[0]);
  split3(c0[2], c0[3], hi[1], mid[1], lo[1]);
  split3(c1[0], c1[1], hi[2], mid[2], lo[2]);
  split3(c1[2], c1[3], hi[3], mid[3], lo[3]);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

}  // namespace hopper
}  // namespace repro
