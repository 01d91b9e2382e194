// Chunked Mamba2 SSD scan, forward (K6), for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
// `_ssd_kernel` behind `ssd_scan`. x [B,L,H,P] (f32 or bf16), dt [B,L,H] f32
// (post-softplus), A [H] f32 (negative), Bm / Cm [B,L,N] (x's dtype, one
// group shared by the heads). Per chunk of q steps, with cum the inclusive
// cumsum of dt * A over the chunk and ct its last value:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//         + exp(cum_i) C_i . S^T                                   (inter)
//   S    <- exp(ct) S + sum_j exp(ct - cum_j) dt_j x_j B_j^T        (carry)
// y is written in f32, the final state S [B,H,P,N] in f32, and, when asked,
// every chunk's ENTERING state [B,NC,H,P,N] f32 (the residual K7 replays).
// L need not be a multiple of q: the last chunk's missing rows are loaded
// as zeros (dt = 0, x = B = C = 0), which leave cum, S and every valid y
// unchanged (exp(0) = 1 and the rows add nothing), and are not written.
//
// What bounds it on the H100: at the training shape (B36 L256 H80 P64 N128,
// bf16, entering states saved) it reads x, B, C, dt once and writes y and
// the states (~570 MB), ~0.17 ms at 3.35 TB/s; its products are ~42 GFLOP
// (at the serving shape B8, ~86 MB and ~9 GFLOP). An f32 FMA body runs
// them far from the tensor cores' rate, many times the bound.
//
// Tensor-core body (bf16, chunk <= 128, P <= 64, N <= 128, as K7's; P and N
// padded with zeros to 64 and 64 or 128): every product on mma.sync
// m16n8k16 (bf16 in, f32 accumulate) from ldmatrix fragments of bf16 tiles
// in shared memory. x, B, C are exact in bf16; the f32 operands W, S and
// x o din are split into three bf16 terms (hi + mid + lo, f32's 24 bits; two
// terms moved training steps in K7), no TF32. One CTA of 8 warps walks the
// chunks of a (head, batch row) item in order; the CTAs are persistent (as
// many as the SMs hold at once), each walking items blockIdx.x + k gridDim.x,
// so the next item's first chunk loads while this one's last computes.
// Warp w owns y's 16-row block w (w < 4) or 11 - w, so that each SM
// sub-partition (warp % 4) holds blocks k and 7 - k, the same work: C.S^T
// (S from shared memory in three terms; skipped on a sequence's first
// chunk, where S is 0) scaled by exp(cum_i), then for each 16-column tile
// j <= i the tile C_i.B_j^T, masked, times G and dt_j in registers, split
// and applied to x_j. No [q,q] buffer. The carry S <- exp(ct) S +
// (x o din)^T.B runs on the same warps, each a 16 x N/2 block of S whose f32
// master lives in its registers across chunks; the entering state is written
// from it, and the new S goes back to shared memory in three terms after a
// barrier. Each k16 step's products are summed on the tensor cores from zero
// and added to the f32 accumulators in f32 (mma3 below): the tensor cores
// round toward zero. At N 128 two stages of x, B, C (86 KB each) and S's
// terms fit 230 KB, one CTA an SM, and cp.async fills the next stage while
// this one computes; at N 64 one stage (83 KB) and two CTAs an SM measured
// faster than two stages and one CTA, and 16 warps a CTA slower than 8 at
// both N (PERF.md section 6). Every output element is written by one
// thread: two runs agree bit for bit.
//
// FMA body (f32, or bf16 shapes the tensor-core body does not take). One
// CTA of 256 threads per (head, batch row) walks the chunks in order, as
// the TPU's sequential last grid axis did; the state S [P,N] f32 lives in
// shared memory across chunks. Shared memory cannot hold the TPU's f32
// tiles (x, B, C, S and the [q,q] matrix W are 256 KB at q = 128, N = 128,
// P = 64), so x, B and C stay in their storage dtype and
// W = (C.B^T) o G o dt is built RB = 32 rows at a time and applied to x
// before the next rows are built. Every product is an f32 FMA. G is taken
// only under the causal mask: for j > i the exponent is positive and could
// overflow, and inf * 0 is NaN. Row strides in shared memory carry one
// extra 16-byte unit, so neighbouring threads that read neighbouring rows
// hit different banks. Each output element is written by one thread; no
// atomics.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA
constexpr int RB = 32;   // rows of W built and applied at a time

struct FwdLayout {
  int xs, bs, fs, ws;  // row strides (elements) of x, B/C, S, W
  size_t off_s, off_w, off_vec, off_x, off_b, off_c, bytes;
};

template <typename T>
__host__ __device__ FwdLayout fwd_layout(int q, int P, int N) {
  FwdLayout L;
  L.xs = P + 16 / (int)sizeof(T);
  L.bs = N + 16 / (int)sizeof(T);
  L.fs = N + 4;
  L.ws = q + 4;
  size_t o = 0;
  L.off_s = o;   o += (size_t)P * L.fs * 4;
  L.off_w = o;   o += (size_t)RB * L.ws * 4;
  L.off_vec = o; o += (size_t)4 * q * 4;        // cum, dt, din, ecum
  L.off_x = o;   o += (size_t)q * L.xs * sizeof(T);
  L.off_b = o;   o += (size_t)q * L.bs * sizeof(T);
  L.off_c = o;   o += (size_t)q * L.bs * sizeof(T);
  L.bytes = o;
  return L;
}

using repro::load8;
using repro::to_f;

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ s_final, float* __restrict__ s_enter,
               int Lseq, int H, int P, int N, int q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout Lo = fwd_layout<T>(q, P, N);
  float* S = reinterpret_cast<float*>(smem + Lo.off_s);
  float* W = reinterpret_cast<float*>(smem + Lo.off_w);
  float* cum = reinterpret_cast<float*>(smem + Lo.off_vec);
  float* dtv = cum + q;
  float* din = dtv + q;
  float* ecum = din + q;
  T* Xs = reinterpret_cast<T*>(smem + Lo.off_x);
  T* Bs = reinterpret_cast<T*>(smem + Lo.off_b);
  T* Cs = reinterpret_cast<T*>(smem + Lo.off_c);
  const int xs = Lo.xs, bs = Lo.bs, fs = Lo.fs, ws = Lo.ws;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nc = (Lseq + q - 1) / q;
  const float a = A[h];

  for (int idx = tid; idx < P * N; idx += NT)
    S[(idx / N) * fs + idx % N] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long t0 = (long)c * q;
    const int rows = min(q, Lseq - (int)t0);  // < q in a short last chunk
    __syncthreads();  // the previous chunk is done with every tile
    repro::load_tile(Xs, xs, x + ((b * (long)Lseq + t0) * H + h) * P,
                     (long)H * P, q, rows, P, NT);
    repro::load_tile(Bs, bs, Bm + (b * (long)Lseq + t0) * N, (long)N, q,
                     rows, N, NT);
    repro::load_tile(Cs, bs, Cm + (b * (long)Lseq + t0) * N, (long)N, q,
                     rows, N, NT);
    for (int j = tid; j < q; j += NT)
      dtv[j] = j < rows ? dt[(b * (long)Lseq + t0 + j) * H + h] : 0.f;
    __syncthreads();
    if (tid < 32) repro::chunk_cumsum(dtv, a, cum, q);
    __syncthreads();
    const float ct = cum[q - 1];
    for (int j = tid; j < q; j += NT) {
      din[j] = expf(ct - cum[j]) * dtv[j];
      ecum[j] = expf(cum[j]);
    }
    __syncthreads();

    for (int r0b = 0; r0b < rows; r0b += RB) {
      // --- W rows [r0b, r0b + RB): (C_i . B_j) G_ij dt_j, j <= i ------------
      // a thread takes a row pair and the 8 columns cg + ncg * k, so that
      // neighbouring threads read neighbouring rows of B
      const int ncg = q / 8;
      for (int tile = tid; tile < (RB / 2) * ncg; tile += NT) {
        const int cg = tile % ncg, rp = tile / ncg;
        const int r0 = 2 * rp, i0 = r0b + r0;
        int kmax = 0;
        while (kmax < 8 && cg + ncg * kmax <= i0 + 1) ++kmax;
        float acc[2][8];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[0][k] = acc[1][k] = 0.f;
        if (kmax > 0) {
          for (int n = 0; n < N; n += 8) {
            float c0[8], c1[8];
            load8(Cs + (size_t)i0 * bs + n, c0);
            load8(Cs + (size_t)(i0 + 1) * bs + n, c1);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if (k < kmax) {
                float bv[8];
                load8(Bs + (size_t)(cg + ncg * k) * bs + n, bv);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  acc[0][k] = fmaf(c0[e], bv[e], acc[0][k]);
                  acc[1][k] = fmaf(c1[e], bv[e], acc[1][k]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = cg + ncg * k;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int i = i0 + s;
            // mask first: exp only of cum_i - cum_j <= 0
            W[(r0 + s) * ws + j] =
                j <= i ? acc[s][k] * expf(cum[i] - cum[j]) * dtv[j] : 0.f;
          }
        }
      }
      __syncthreads();

      // --- y rows [r0b, r0b + RB): W . x + exp(cum_i) C_i . S^T -----------
      // a thread takes a row pair and the 4 columns pg + npg * k
      const int npg = P / 4;
      for (int tile = tid; tile < (RB / 2) * npg; tile += NT) {
        const int pg = tile % npg, rp = tile / npg;
        const int r0 = 2 * rp, i0 = r0b + r0;
        float acc[2][4], cs[2][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[0][k] = acc[1][k] = cs[0][k] = cs[1][k] = 0.f;
        for (int j = 0; j <= i0 + 1; ++j) {
          const float w0 = W[r0 * ws + j], w1 = W[(r0 + 1) * ws + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float xv = to_f(Xs[(size_t)j * xs + pg + npg * k]);
            acc[0][k] = fmaf(w0, xv, acc[0][k]);
            acc[1][k] = fmaf(w1, xv, acc[1][k]);
          }
        }
        for (int n = 0; n < N; n += 8) {
          float c0[8], c1[8];
          load8(Cs + (size_t)i0 * bs + n, c0);
          load8(Cs + (size_t)(i0 + 1) * bs + n, c1);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float sv[8];
            load8(S + (size_t)(pg + npg * k) * fs + n, sv);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              cs[0][k] = fmaf(c0[e], sv[e], cs[0][k]);
              cs[1][k] = fmaf(c1[e], sv[e], cs[1][k]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int i = i0 + s;
          if (i >= rows) break;
          float* yrow = y + ((b * (long)Lseq + t0 + i) * H + h) * P;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            yrow[pg + npg * k] = acc[s][k] + ecum[i] * cs[s][k];
        }
      }
      __syncthreads();
    }

    // --- S <- exp(ct) S + sum_j din_j x_j B_j^T (entering state saved first)
    const float ect = expf(ct);
    const int nng = N / 8;
    for (int tile = tid; tile < (P / 4) * nng; tile += NT) {
      const int ng = tile % nng, pg = tile / nng;
      const int p0 = 4 * pg, n0 = 8 * ng;
      float sv[4][8], acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        load8(S + (size_t)(p0 + r) * fs + n0, sv[r]);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
      }
      if (s_enter != nullptr) {
        float* dst = s_enter + (((b * (long)nc + c) * H + h) * P + p0) * N
                     + n0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reinterpret_cast<float4*>(dst + (size_t)r * N)[0] =
              make_float4(sv[r][0], sv[r][1], sv[r][2], sv[r][3]);
          reinterpret_cast<float4*>(dst + (size_t)r * N)[1] =
              make_float4(sv[r][4], sv[r][5], sv[r][6], sv[r][7]);
        }
      }
      for (int j = 0; j < rows; ++j) {
        float bv[8];
        load8(Bs + (size_t)j * bs + n0, bv);
        const float d = din[j];
        float xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          xv[r] = to_f(Xs[(size_t)j * xs + p0 + r]) * d;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(xv[r], bv[e], acc[r][e]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          S[(size_t)(p0 + r) * fs + n0 + e] = ect * sv[r][e] + acc[r][e];
    }
  }
  __syncthreads();
  float* dst = s_final + ((long)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += NT)
    dst[idx] = S[(idx / N) * fs + idx % N];
}

template <typename T>
int launch_fwd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* s_final, void* s_enter, int Bsz,
               int Lseq, int H, int P, int N, int q, cudaStream_t st) {
  const size_t bytes = fwd_layout<T>(q, P, N).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return repro::refused(err);
  ssd_fwd_kernel<T><<<dim3(H, Bsz), NT, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(s_final), static_cast<float*>(s_enter), Lseq, H, P,
      N, q);
  return (int)cudaGetLastError();
}

// ===========================================================================
// Tensor-core body (bf16): see the note at the top
// ===========================================================================

namespace tc {

namespace hp = repro::hopper;
using bf16 = __nv_bfloat16;

constexpr int NTH = 256;      // 8 warps
constexpr int QMAX = 128;     // chunk rows
constexpr int PT = 64;        // P, padded with zeros
constexpr int XS = PT + 8;    // row stride of the [q][P] tiles (144 bytes)

// STAGES copies of the bf16 x, B, C tiles, S in three bf16 terms, then four
// f32 vectors of QMAX. Row strides are an odd number of 16-byte units, so
// ldmatrix reads them without bank conflicts.
template <int NN, int STAGES>
struct Lay {
  static constexpr int BS = NN + 8;                    // [.][N] row stride
  static constexpr size_t XT = (size_t)QMAX * XS * 2;  // a [q][P] tile
  static constexpr size_t BT = (size_t)QMAX * BS * 2;  // a [q][N] tile
  static constexpr size_t PN = (size_t)PT * BS * 2;    // a [P][N] tile
  static constexpr size_t stage = XT + 2 * BT;         // x, B, C
  static constexpr size_t s = STAGES * stage,          // S hi, mid, lo
                          vec = s + 3 * PN,            // dt, cum, e, din
                          bytes = vec + 4 * QMAX * 4;
};

// Stages of x, B, C and CTAs an SM, by N (padded to 64 or 128): see the
// note at the top
template <int NN> struct Cfg;
template <> struct Cfg<128> { static constexpr int STAGES = 2, CTAS = 1; };
template <> struct Cfg<64> { static constexpr int STAGES = 1, CTAS = 2; };

// d += a . b for one k16 step of three terms (A's, or B's: the other
// operand repeats): the three products summed on the tensor cores from zero,
// largest term first, then added to d in f32 (rounded to nearest). The
// tensor cores round their sums toward zero; a chain of mma.sync through d
// would do so at every step of a long sum and bias d toward zero (on an
// H100, 4.2e-7 of |y| on mamba2-2.7b's own inputs against the FMA body's
// 9e-9; this way 1.0e-7; PERF.md section 6).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a0)[4],
                                     const uint32_t (&a1)[4],
                                     const uint32_t (&a2)[4], uint32_t b00,
                                     uint32_t b01, uint32_t b10, uint32_t b11,
                                     uint32_t b20, uint32_t b21) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  hp::mma16816(t, a0, b00, b01);
  hp::mma16816(t, a1, b10, b11);
  hp::mma16816(t, a2, b20, b21);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

template <int NN>
__global__ void __launch_bounds__(NTH, Cfg<NN>::CTAS)
ssd_fwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, float* __restrict__ y,
                  float* __restrict__ s_final, float* __restrict__ s_enter,
                  int Bsz, int Lseq, int H, int P, int N, int q) {
  constexpr int STAGES = Cfg<NN>::STAGES;
  using L = Lay<NN, STAGES>;
  constexpr int BS = L::BS;
  constexpr int NP8 = PT / 8;        // n8 tiles across P
  constexpr int CN8 = NN / 16;       // n8 tiles of a warp's carry block
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Sh = reinterpret_cast<bf16*>(smem + L::s);
  bf16* Sm = Sh + PT * BS;
  bf16* Sl = Sm + PT * BS;
  float* dtv = reinterpret_cast<float*>(smem + L::vec);
  float* cum = dtv + QMAX;
  float* ev = cum + QMAX;      // exp(cum)
  float* din = ev + QMAX;      // exp(ct - cum) dt

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const hp::Lane ln(lane);
  const int nc = (Lseq + q - 1) / q, items = H * Bsz;
  const int rb = warp < 4 ? warp : 11 - warp;
  const long hp_row = (long)H * P;

  // chunk c of item it (head it % H, batch row it / H): its x, B, C into
  // stage `slot` by cp.async (one group), rows past the sequence and
  // columns past P, N as zeros
  auto load_chunk = [&](int it, int c, int slot) {
    unsigned char* st = smem + slot * L::stage;
    bf16* Xs = reinterpret_cast<bf16*>(st);
    bf16* Bs = reinterpret_cast<bf16*>(st + L::XT);
    bf16* Cs = reinterpret_cast<bf16*>(st + L::XT + L::BT);
    const int h = it % H, b = it / H;
    const long t0 = (long)c * q;
    const int rows = min(q, Lseq - (int)t0);
    const bf16* xg = x + ((b * (long)Lseq + t0) * H + h) * P;
    for (int idx = tid; idx < q * (PT / 8); idx += NTH) {
      const int r = idx / (PT / 8), cc = (idx % (PT / 8)) * 8;
      const bool ok = r < rows && cc < P;
      hp::cp_async16(Xs + r * XS + cc, ok ? xg + r * hp_row + cc : xg, ok);
    }
    const bf16* bg = Bm + (b * (long)Lseq + t0) * N;
    const bf16* cg = Cm + (b * (long)Lseq + t0) * N;
    for (int idx = tid; idx < q * (NN / 8); idx += NTH) {
      const int r = idx / (NN / 8), cc = (idx % (NN / 8)) * 8;
      const bool ok = r < rows && cc < N;
      hp::cp_async16(Bs + r * BS + cc, ok ? bg + (long)r * N + cc : bg, ok);
      hp::cp_async16(Cs + r * BS + cc, ok ? cg + (long)r * N + cc : cg, ok);
    }
    hp::cp_async_commit();
  };
  // thread j's dt of that chunk (0 past the sequence), into a register
  auto load_dt = [&](int it, int c) {
    const long t = (long)c * q + tid;
    return tid < q && t < Lseq
               ? dt[((it / H) * (long)Lseq + t) * H + it % H]
               : 0.f;
  };

  // S's f32 master: p rows [pc0, pc0 + 16), n columns [nc0, nc0 + NN/2);
  // lane (g, t4) holds rows pc0 + g (+ 8), columns nc0 + 8 nt + 2 t4 (+ 1)
  const int pc0 = 16 * (warp & 3), nc0 = (warp >> 2) * (NN / 2);
  float Sr[CN8][4];
#pragma unroll
  for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) Sr[nt][e] = 0.f;
  auto store_s = [&]() {      // the master in three terms, for C . S^T
#pragma unroll
    for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int o = (pc0 + g + 8 * hf) * BS + nc0 + 8 * nt + 2 * t4;
        uint32_t hi, mi, lo;
        hp::split3(Sr[nt][2 * hf], Sr[nt][2 * hf + 1], hi, mi, lo);
        *reinterpret_cast<uint32_t*>(Sh + o) = hi;
        *reinterpret_cast<uint32_t*>(Sm + o) = mi;
        *reinterpret_cast<uint32_t*>(Sl + o) = lo;
      }
  };
  auto write_s = [&](float* dst) {  // the master to [P, N] f32 in global
#pragma unroll
    for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = pc0 + g + 8 * hf, n = nc0 + 8 * nt + 2 * t4;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(dst + (long)p * N + n) =
              make_float2(Sr[nt][2 * hf], Sr[nt][2 * hf + 1]);
      }
  };

  // The CTA walks items blockIdx.x, + gridDim.x, ..., each item's chunks in
  // order; with two stages the next (item, chunk) loads during this one.
  int it = blockIdx.x, c = 0, slot = 0;
  float dt_cur = 0.f;
  if (it < items) {
    load_chunk(it, 0, 0);
    dt_cur = load_dt(it, 0);
  }
  while (it < items) {
    const int h = it % H, b = it / H;
    const long t0 = (long)c * q;
    const int rows = min(q, Lseq - (int)t0);  // < q in a short last chunk
    const int it2 = c + 1 < nc ? it : it + gridDim.x;
    const int c2 = c + 1 < nc ? c + 1 : 0;
    const bool ahead = STAGES == 2 && it2 < items;
    float dt_nxt = 0.f;
    if (ahead) {
      load_chunk(it2, c2, slot ^ 1);
      dt_nxt = load_dt(it2, c2);
    }
    if (tid < q) dtv[tid] = dt_cur;
    if (s_enter != nullptr)
      write_s(s_enter + (((long)b * nc + c) * H + h) * P * N);
    if (ahead)
      hp::cp_async_wait<1>();
    else
      hp::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) repro::chunk_cumsum(dtv, A[h], cum, q);
    __syncthreads();
    const float ct = cum[q - 1];
    for (int j = tid; j < q; j += NTH) {
      ev[j] = expf(cum[j]);
      din[j] = expf(ct - cum[j]) * dtv[j];
    }
    __syncthreads();
    const unsigned char* st = smem + slot * L::stage;
    const bf16* Xs = reinterpret_cast<const bf16*>(st);
    const bf16* Bs = reinterpret_cast<const bf16*>(st + L::XT);
    const bf16* Cs = reinterpret_cast<const bf16*>(st + L::XT + L::BT);

    // ===== y, rows of block rb: exp(cum_i) C_i . S^T + W . x =================
    if (16 * rb < rows) {
      const int i0 = 16 * rb, ia = i0 + g, ib = ia + 8;
      float acc[NP8][4];
#pragma unroll
      for (int nt = 0; nt < NP8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      if (c > 0) {      // C . S^T, S as hi + mid + lo (S is 0 entering c 0)
#pragma unroll
        for (int kk = 0; kk < NN / 16; ++kk) {
          uint32_t af[4];
          hp::ldsm4(af, Cs + (i0 + ln.a_r) * BS + kk * 16 + ln.a_c);
#pragma unroll
          for (int pp = 0; pp < PT / 16; ++pp) {
            uint32_t bh[4], bm[4], bl[4];
            const int o = (pp * 16 + ln.b_n) * BS + kk * 16 + ln.b_k;
            hp::ldsm4(bh, Sh + o);
            hp::ldsm4(bm, Sm + o);
            hp::ldsm4(bl, Sl + o);
#pragma unroll
            for (int u = 0; u < 2; ++u)
              mma3(acc[2 * pp + u], af, af, af, bh[2 * u], bh[2 * u + 1],
                   bm[2 * u], bm[2 * u + 1], bl[2 * u], bl[2 * u + 1]);
          }
        }
        const float ea = ev[ia], eb = ev[ib];
#pragma unroll
        for (int nt = 0; nt < NP8; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
      }
      // + W . x over the column tiles j <= i, W = (C . B^T) o G o dt_j with
      // the mask before the exponential, W as hi + mid + lo
      const float cia = cum[ia], cib = cum[ib];
      for (int jt = 0; jt <= rb; ++jt) {
        const int j0 = 16 * jt;
        // each k-step from zero on the tensor cores, added in f32 (mma3)
        float w[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < NN / 16; ++kk) {
          uint32_t af[4], bf[4];
          hp::ldsm4(af, Cs + (i0 + ln.a_r) * BS + kk * 16 + ln.a_c);
          hp::ldsm4(bf, Bs + (j0 + ln.b_n) * BS + kk * 16 + ln.b_k);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            hp::mma16816(t, af, bf[2 * u], bf[2 * u + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) w[u][e] += t[e];
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int j = j0 + 8 * u + 2 * t4 + (e & 1);
            w[u][e] = j <= i ? w[u][e] * expf((e < 2 ? cia : cib) - cum[j])
                                   * dtv[j]
                             : 0.f;
          }
        uint32_t wh[4], wm[4], wl[4];
        hp::a_split3(wh, wm, wl, w[0], w[1]);
#pragma unroll
        for (int pp = 0; pp < PT / 16; ++pp) {
          uint32_t bf[4];
          hp::ldsm4_t(bf, Xs + (j0 + ln.bt_k) * XS + pp * 16 + ln.bt_n);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma3(acc[2 * pp + u], wh, wm, wl, bf[2 * u], bf[2 * u + 1],
                 bf[2 * u], bf[2 * u + 1], bf[2 * u], bf[2 * u + 1]);
        }
      }
      float* yg = y + ((b * (long)Lseq + t0) * H + h) * P;
#pragma unroll
      for (int nt = 0; nt < NP8; ++nt) {
        const int p = 8 * nt + 2 * t4;
        if (p < P) {
          if (ia < rows)
            *reinterpret_cast<float2*>(yg + ia * hp_row + p) =
                make_float2(acc[nt][0], acc[nt][1]);
          if (ib < rows)
            *reinterpret_cast<float2*>(yg + ib * hp_row + p) =
                make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }

    // ===== carry: S <- exp(ct) S + (x o din)^T . B ============================
    float cacc[CN8][4];
#pragma unroll
    for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[nt][e] = 0.f;
    for (int kk = 0; kk < (rows + 15) / 16; ++kk) {
      // the A fragment of (x o din)^T: k (the rows j) 2 t4 (+1) in
      // registers 0-1, 2 t4 + 8 (+1) in 2-3, as hi + mid + lo
      uint32_t xf[4], ah[4], am[4], al[4];
      hp::ldsm4_t(xf, Xs + (kk * 16 + ln.at_k) * XS + pc0 + ln.at_m);
      const int k0 = kk * 16 + 2 * t4;
      const float d0 = din[k0], d1 = din[k0 + 1], d8 = din[k0 + 8],
                  d9 = din[k0 + 9];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = hp::unpack_bf16(xf[r]);
        hp::split3(f.x * (r < 2 ? d0 : d8), f.y * (r < 2 ? d1 : d9), ah[r],
                   am[r], al[r]);
      }
#pragma unroll
      for (int np = 0; np < CN8 / 2; ++np) {
        uint32_t bf[4];
        hp::ldsm4_t(bf, Bs + (kk * 16 + ln.bt_k) * BS + nc0 + np * 16 +
                            ln.bt_n);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          mma3(cacc[2 * np + u], ah, am, al, bf[2 * u], bf[2 * u + 1],
               bf[2 * u], bf[2 * u + 1], bf[2 * u], bf[2 * u + 1]);
      }
    }
    __syncthreads();  // every warp is done with S's terms and this stage
    if (STAGES == 1 && it2 < items) {
      load_chunk(it2, c2, 0);
      dt_nxt = load_dt(it2, c2);
    }
    const float ect = expf(ct);
#pragma unroll
    for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) Sr[nt][e] = ect * Sr[nt][e] + cacc[nt][e];
    if (c2 > 0) {
      store_s();
    } else {          // the item's last chunk: its final state, then S = 0
      write_s(s_final + ((long)b * H + h) * P * N);
#pragma unroll
      for (int nt = 0; nt < CN8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) Sr[nt][e] = 0.f;
    }
    it = it2;
    c = c2;
    slot = (slot + 1) % STAGES;
    dt_cur = dt_nxt;
  }
}

}  // namespace tc

// whether the tensor-core body takes the shape (bf16 only): as K7's
bool tc_body(int P, int N, int q) {
  return q <= tc::QMAX && P <= tc::PT && N <= 128;
}

template <int NN>
int launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* y, void* s_final, void* s_enter, int Bsz,
              int Lseq, int H, int P, int N, int q, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const size_t bytes = tc::Lay<NN, tc::Cfg<NN>::STAGES>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      tc::ssd_fwd_tc_kernel<NN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return repro::refused(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return repro::refused(err);
  // persistent: as many CTAs as the SMs hold at once, or one an item
  const int slots = sms * tc::Cfg<NN>::CTAS;
  const int grid = H * Bsz < slots ? H * Bsz : slots;
  tc::ssd_fwd_tc_kernel<NN><<<grid, tc::NTH, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<float*>(y),
      static_cast<float*>(s_final), static_cast<float*>(s_enter), Bsz, Lseq,
      H, P, N, q);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* s_final, void* s_enter, int Bsz,
           int Lseq, int H, int P, int N, int q, int dtype, bool fma,
           cudaStream_t st) {
  if (dtype == repro::DTYPE_F32)
    return launch_fwd<float>(x, dt, A, Bm, Cm, y, s_final, s_enter, Bsz, Lseq,
                             H, P, N, q, st);
  if (fma || !tc_body(P, N, q))
    return launch_fwd<__nv_bfloat16>(x, dt, A, Bm, Cm, y, s_final, s_enter,
                                     Bsz, Lseq, H, P, N, q, st);
  if (N <= 64)
    return launch_tc<64>(x, dt, A, Bm, Cm, y, s_final, s_enter, Bsz, Lseq, H,
                         P, N, q, st);
  return launch_tc<128>(x, dt, A, Bm, Cm, y, s_final, s_enter, Bsz, Lseq, H,
                        P, N, q, st);
}

}  // namespace

// s_enter may be null (no entering states written).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* s_final, void* s_enter, int Bsz, int Lseq,
                            int H, int P, int N, int q, int dtype,
                            void* stream) {
  if (repro::bad_ssd_shape(Bsz, Lseq, H, P, N, q))
    return (int)cudaErrorInvalidValue;
  return launch(x, dt, A, Bm, Cm, y, s_final, s_enter, Bsz, Lseq, H, P, N, q,
                dtype, false, static_cast<cudaStream_t>(stream));
}

// The same on the FMA body whatever the dtype and shape: for holding the
// tensor-core body against it (tests, chip_smoke.py), never on a model path.
extern "C" int ssd_scan_fwd_fma(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm, void* y,
                                void* s_final, void* s_enter, int Bsz,
                                int Lseq, int H, int P, int N, int q,
                                int dtype, void* stream) {
  if (repro::bad_ssd_shape(Bsz, Lseq, H, P, N, q))
    return (int)cudaErrorInvalidValue;
  return launch(x, dt, A, Bm, Cm, y, s_final, s_enter, Bsz, Lseq, H, P, N, q,
                dtype, true, static_cast<cudaStream_t>(stream));
}

// 1 if ssd_scan_fwd runs the tensor-core body on this shape and dtype, else 0
extern "C" int ssd_scan_fwd_tc_body(int P, int N, int q, int dtype) {
  return dtype == repro::DTYPE_BF16 && tc_body(P, N, q) ? 1 : 0;
}
