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
// arithmetic is tiny. At the serving path's own shapes (a cache of 20
// slots) the launch itself dominates. It is called once per layer per
// decoded token (7 x 32 times per batch for openvla-7b).
//
// Design (flash-decoding). The cache's 64-slot tiles are split over the CTAs
// of a thread-block cluster: grid (splits, KV x head blocks, B), cluster
// (splits, 1, 1), at most 8 splits, each a run of whole tiles (the wrapper
// chooses the layout from S: one tile a split up to 8 tiles, so B8 S275
// launches 5 x 256 CTAs). A CTA serves up to GB query heads of one kv head,
// so K/V are read from device memory once for G <= 8. Its tiles arrive by
// cp.async in their own dtype (the slots past S as zeros), K and V in
// separate groups, and with two tiles or more the next tile's loads are in
// flight while this one computes. Scores: every warp takes slots, a slot's
// head row spread over 2-32 lanes with 16-byte loads and a shuffle
// reduction. Online softmax in f32 with the reference's conventions: masked
// slots score -inf and contribute 0 while the running max keeps the finite
// NEG_INF sentinel; P is rounded to the value dtype before the PV product.
// PV: a thread owns 8 columns and every (128 / (D/8))-th slot, its partial
// sums live in registers across the split's tiles and are summed over the
// slot groups in a fixed order at the end. Each CTA ends with f32 (m, l,
// acc[G, D]); after a cluster barrier, every rank reads all ranks' through
// distributed shared memory in rank order, weights each by
// exp(m_r - max_r m_r) (0 for a wholly masked split, whose m is the
// sentinel: never NaN) and writes o; rank r takes the r-th share of the
// outputs, so the ranks combine in parallel. One launch, no atomics: reruns
// are bit for bit. With one split (S <= 64: the served caches of 19-20
// slots) there is no cluster and the CTA writes o itself. The order of
// arithmetic is kernels/ref.py::tiled_softmax_attention with `split` =
// tiles per split x 64. The tile's validity bytes are loaded with its K and
// V, and after the last tile the partial sums reuse K's and V's shared
// memory (33 KB a CTA at D 128: 6 CTAs an SM).

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::NEG_INF;
namespace hp = repro::hopper;

constexpr int TILE = 64;        // cache slots per tile (ref.py KERNEL_TILE)
constexpr int NT = 128;         // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr size_t MAX_SMEM = 227 * 1024;

struct DecodeLayout {
  size_t off_k, off_v, off_p, off_vs, off_ml, bytes;
};

// K's stages, then V's; after the last tile the slot groups' partial sums
// reuse K's bytes and the CTA's acc [GB][D] V's. Then the scores [GB][TILE],
// the tile's validity bytes and m, l, corr [GB].
template <typename T>
__host__ __device__ DecodeLayout decode_layout(int GB, int D, int stages) {
  DecodeLayout L;
  const size_t kv = (size_t)stages * TILE * D * sizeof(T);
  const size_t red = (size_t)(NT / (D / 8)) * GB * D * 4;
  size_t o = 0;
  L.off_k = o;  o += kv > red ? kv : red;
  L.off_v = o;  o += kv;
  L.off_p = o;  o += (size_t)GB * TILE * 4;
  L.off_vs = o; o += TILE;
  L.off_ml = o; o += (size_t)3 * GB * 4;
  L.bytes = o;
  return L;
}

template <typename T, int GB>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ valid,
              T* __restrict__ o, int S, int H, int KV, int D, float scale,
              int tps, int stages, int gblocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DecodeLayout Lo = decode_layout<T>(GB, D, stages);
  T* Ks = reinterpret_cast<T*>(smem + Lo.off_k);
  T* Vs = reinterpret_cast<T*>(smem + Lo.off_v);
  float* red = reinterpret_cast<float*>(smem + Lo.off_k);  // after the loop
  float* acc_s = reinterpret_cast<float*>(smem + Lo.off_v);
  float* Ps = reinterpret_cast<float*>(smem + Lo.off_p);   // [GB][TILE]
  uint8_t* vs = smem + Lo.off_vs;
  float* m_s = reinterpret_cast<float*>(smem + Lo.off_ml);
  float* l_s = m_s + GB;
  float* c_s = l_s + GB;

  const int G = H / KV;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y / gblocks, g0 = (blockIdx.y % gblocks) * GB;
  const int gn = min(GB, G - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int ntiles = (S + TILE - 1) / TILE;
  const int t_begin = split * tps, t_end = min(ntiles, t_begin + tps);
  const long row = (long)KV * D;             // elements between slots
  const T* kb = k + (long)b * S * row + (long)kvh * D;
  const T* vb = v + (long)b * S * row + (long)kvh * D;
  const uint8_t* valid_b = valid + (long)b * S;
  const long h0 = (long)b * H + (long)kvh * G + g0;   // first query head

  // one tile's K or V rows into stage `st`, 16 bytes a thread, slots past S
  // as zeros; one cp.async group
  constexpr int E16 = 16 / (int)sizeof(T);
  const int c16 = D / E16;
  auto issue = [&](const T* src, T* dst, int t, int st) {
    T* d = dst + (size_t)st * TILE * D;
    for (int idx = tid; idx < TILE * c16; idx += NT) {
      const int r = idx / c16, cc = (idx - r * c16) * E16;
      const int s = t * TILE + r;
      const bool ok = s < S;
      hp::cp_async16(d + r * D + cc, ok ? src + s * row + cc : src, ok);
    }
    hp::cp_async_commit();
  };
  // a tile's validity byte for slot tid, loaded with its K and V and
  // stored to shared memory once they have landed
  auto valid_at = [&](int t) -> uint8_t {
    const int s = t * TILE + tid;
    return tid < TILE && s < S ? valid_b[s] : 0;
  };

  // scores: lpr lanes a slot (8 elements each), spw slots a warp and pass
  const int cpr = D / 8;
  int lpr = 1;
  while (lpr < cpr) lpr *= 2;                 // <= 32: D <= 256
  const int spw = 32 / lpr, li = lane % lpr, sub = lane / lpr;
  float qr[GB][8];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[gi][e] = 0.f;
    if (gi < gn && li < cpr) repro::load8(q + (h0 + gi) * D + li * 8, qr[gi]);
  }
  // PV: thread (slot group jg, 8 columns c)
  const int c = tid % cpr, jg = tid / cpr, njg = NT / cpr;
  float accr[GB][8];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi)
#pragma unroll
    for (int e = 0; e < 8; ++e) accr[gi][e] = 0.f;
  if (tid < GB) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  issue(kb, Ks, t_begin, 0);
  issue(vb, Vs, t_begin, 0);
  uint8_t vnext = valid_at(t_begin);
  for (int t = t_begin; t < t_end; ++t) {
    const int st = stages == 2 ? (t - t_begin) & 1 : 0;
    const bool next = t + 1 < t_end;
    const uint8_t vcur = vnext;
    if (next && stages == 2) {
      issue(kb, Ks, t + 1, st ^ 1);
      issue(vb, Vs, t + 1, st ^ 1);
      vnext = valid_at(t + 1);
      hp::cp_async_wait<3>();              // K(t) has landed
    } else {
      hp::cp_async_wait<1>();
    }
    if (tid < TILE) vs[tid] = vcur;
    __syncthreads();

    const T* Kt = Ks + (size_t)st * TILE * D;
#pragma unroll 4
    for (int base = warp * spw; base < TILE; base += NWARP * spw) {
      const int s = base + sub;
      float d[GB];
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) d[gi] = 0.f;
      if (li < cpr) {
        float kf[8];
        repro::load8(Kt + s * D + li * 8, kf);
#pragma unroll
        for (int gi = 0; gi < GB; ++gi)
#pragma unroll
          for (int e = 0; e < 8; ++e) d[gi] = fmaf(qr[gi][e], kf[e], d[gi]);
      }
      for (int off = lpr / 2; off > 0; off >>= 1)
#pragma unroll
        for (int gi = 0; gi < GB; ++gi)
          d[gi] += __shfl_xor_sync(0xffffffffu, d[gi], off);
      if (li == 0) {
        const bool ok = vs[s] != 0;        // 0 past S
#pragma unroll
        for (int gi = 0; gi < GB; ++gi)
          Ps[gi * TILE + s] = ok ? d[gi] * scale : -INFINITY;
      }
    }
    __syncthreads();

    for (int gi = warp; gi < gn; gi += NWARP) {
      float* pg = Ps + gi * TILE;
      const float x0 = pg[lane], x1 = pg[lane + 32];
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, repro::warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float sum = repro::warp_sum(p0 + p1);
      pg[lane] = repro::round_to<T>(p0);
      pg[lane + 32] = repro::round_to<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[gi] = corr;
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
      }
    }
    if (next && stages == 2)
      hp::cp_async_wait<2>();              // V(t) has landed
    else
      hp::cp_async_wait<0>();
    __syncthreads();

    if (jg < njg) {
      const T* Vt = Vs + (size_t)st * TILE * D;
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        const float corr = gi < gn ? c_s[gi] : 1.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) accr[gi][e] *= corr;
      }
#pragma unroll 4
      for (int j = jg; j < TILE; j += njg) {
        float vf[8];
        repro::load8(Vt + j * D + c * 8, vf);
#pragma unroll
        for (int gi = 0; gi < GB; ++gi) {
          const float p = gi < gn ? Ps[gi * TILE + j] : 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) accr[gi][e] = fmaf(p, vf[e], accr[gi][e]);
        }
      }
    }
    __syncthreads();                       // stage st and Ps are free
    if (next && stages == 1) {
      issue(kb, Ks, t + 1, 0);
      issue(vb, Vs, t + 1, 0);
      vnext = valid_at(t + 1);
    }
  }

  // the slot groups' partial sums, in group order
  if (jg < njg)
#pragma unroll
    for (int gi = 0; gi < GB; ++gi)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[((size_t)jg * GB + gi) * D + c * 8 + e] = accr[gi][e];
  __syncthreads();
  for (int idx = tid; idx < gn * D; idx += NT) {
    const int gi = idx / D, d = idx - gi * D;
    float s = 0.f;
    for (int j = 0; j < njg; ++j) s += red[((size_t)j * GB + gi) * D + d];
    if (nsplit == 1)
      o[h0 * D + idx] = repro::from_f<T>(s / fmaxf(l_s[gi], 1e-30f));
    else
      acc_s[idx] = s;
  }
  if (nsplit == 1) return;

  // combine the splits: rank r writes the r-th share of the outputs, each
  // from every rank's (m, l, acc) read in rank order
  __syncthreads();
  hp::cluster_sync();
  const int share = (gn * D + nsplit - 1) / nsplit;
  const int i_end = min(gn * D, (split + 1) * share);
  for (int idx = split * share + tid; idx < i_end; idx += NT) {
    const int gi = idx / D;
    float mr[MAX_SPLITS], mt = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < nsplit) {
        mr[r] = hp::ld_dsmem(m_s + gi, r);
        mt = fmaxf(mt, mr[r]);
      }
    float lt = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < nsplit) {
        const float w = expf(mr[r] - mt);
        lt += hp::ld_dsmem(l_s + gi, r) * w;
        a += hp::ld_dsmem(acc_s + idx, r) * w;
      }
    o[h0 * D + idx] = repro::from_f<T>(a / fmaxf(lt, 1e-30f));
  }
  hp::cluster_sync();                      // keep every rank's smem alive
}

template <typename T, int GB>
int launch_gb(const void* q, const void* k, const void* v, const void* valid,
              void* o, int B, int S, int H, int KV, int D, float scale,
              int splits, cudaStream_t stream) {
  const int G = H / KV, gblocks = (G + GB - 1) / GB;
  const int ntiles = (S + TILE - 1) / TILE;
  const int tps = (ntiles + splits - 1) / splits;
  if (splits < 1 || splits > MAX_SPLITS || (splits - 1) * tps >= ntiles ||
      (long)KV * gblocks > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;       // an empty split, or too many
  int stages = tps > 1 ? 2 : 1;
  if (decode_layout<T>(GB, D, stages).bytes > MAX_SMEM) stages = 1;
  const size_t smem = decode_layout<T>(GB, D, stages).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return repro::refused(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KV * gblocks, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, decode_kernel<T, GB>,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v),
                           static_cast<const uint8_t*>(valid),
                           static_cast<T*>(o), S, H, KV, D, scale, tps,
                           stages, gblocks);
  if (err != cudaSuccess) return repro::refused(err);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* o, int B, int S, int H, int KV, int D, float scale,
           int splits, cudaStream_t st) {
  const int G = H / KV;
  if (G <= 1)
    return launch_gb<T, 1>(q, k, v, valid, o, B, S, H, KV, D, scale, splits,
                           st);
  if (G <= 2)
    return launch_gb<T, 2>(q, k, v, valid, o, B, S, H, KV, D, scale, splits,
                           st);
  if (G <= 4)
    return launch_gb<T, 4>(q, k, v, valid, o, B, S, H, KV, D, scale, splits,
                           st);
  return launch_gb<T, 8>(q, k, v, valid, o, B, S, H, KV, D, scale, splits,
                         st);
}

}  // namespace

// `splits`: CTAs (one cluster) a (kv head, batch row) splits the cache's
// 64-slot tiles over, as kernels/decode_attention.py::split_layout chooses
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* valid, void* o,
                                    int B, int S, int H, int KV, int D,
                                    int dtype, float scale, int splits,
                                    void* stream) {
  if (D % 8 != 0 || D > 256 || H % KV != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return launch<float>(q, k, v, valid, o, B, S, H, KV, D, scale, splits,
                         st);
  if (dtype == repro::DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, valid, o, B, S, H, KV, D, scale,
                                 splits, st);
  return (int)cudaErrorInvalidValue;
}
