// Grouped matrix product over rows sorted by group, and its weight
// gradient: the port's counterpart of lax.ragged_dot as the reference's
// MoE layer uses it
//   src/repro/models/layers.py:605-609 (an XLA op; no Pallas kernel).
//
//   y[r] = x[r] w[e]            for ends[e-1] <= r < ends[e]
//   y[r] = 0                    for ends[E-1] <= r < M
//   dw[e] = x[group e]^T dy[group e]    (zeros for an empty group)
//
// x (M, K), w (E, K, N) -- or (E, N, K) with `trans`, read transposed in
// place (the input gradient's product dy w[e]^T, no copy of w) -- ends
// (E,) int32, the running sums of the group sizes, read on the device:
// the host never waits for them, and every grid comes from the shapes
// (and, for bf16, the SM count) alone.
//
// What bounds them on an H100.  The forward must read each expert that
// has rows once: qwen3-moe's decode puts 32 rows on ~23 of 128 experts
// (289 MB of weights), its 256-token prefill ~16 rows on each of ~100
// (1.3 GB), llama4's decode one row on each of at most 4 experts of 84
// MB.  At 2 K N flops a row that is far below the 295 flops a byte where
// the tensor cores would bind: these products are bound by the used
// experts' bytes at 3.35 TB/s.  The weight gradient writes every
// expert's dw, zero or not (1.61 GB at qwen3-moe's widths): bound by
// those writes.
//
// bf16 (sm_90a), what the design does about it:
//  * TMA in, wgmma on top.  One producer warp keeps a ring of stages in
//    flight through the Tensor Memory Accelerator (a 3-D tensor map over
//    w, 2-D maps over x / dy, 128-byte swizzle; one thread issues a whole
//    tile, an mbarrier counts its bytes), so the bytes in flight no
//    longer depend on how many threads copy.  Two consumer warpgroups
//    run wgmma.mma_async on the stages that have landed, f32 accumulate.
//  * The forward swaps A and B (y^T = w[e]^T x^T): the weight's columns
//    take wgmma's 64-row M side (one warpgroup each, 128 columns a tile)
//    and the group's rows its n side, n = 16 / 32 / 64 / 128 chosen per
//    tile from the rows it holds (a 4-row decode group pays for a
//    16-row product, a 1,000-row group takes 128-row tiles).  The dx
//    instance reads w[e] as (N, K), K-major, through its own map: wgmma
//    takes either major order, so no copy and no transposed gather.
//  * A persistent grid (min(SMs, most units the shapes allow) CTAs) walks
//    a list of work units that every warp derives from `ends` on the
//    card, in the order tile_walk() in kernels/grouped_mm.py specifies:
//    expert by expert, so all row tiles of one expert's column tile are
//    in flight together and its weights come from HBM about once (the
//    rest from L2), then the tail of zero rows past ends[E-1].
//  * When the shapes allow too few tiles to fill the card (llama4's
//    decode: 4 experts x 40-64 column tiles), K is split by a count from
//    the shapes alone (kernels/grouped_mm.py: fwd_splits); each split
//    writes f32 partials, and a second pass sums them in split order
//    and writes y, zeros past ends[E-1] included.  No atomics: every
//    element is written by one thread, a second call gives the same bits.
//  * Stores: a forward tile goes through shared memory and out as
//    masked 16-byte rows (a row tile that ends inside a group writes
//    none of the next group's rows).  The weight gradient's dw tile
//    (128 x 128) is staged swizzled in shared memory and written by TMA
//    stores, four buffers a warpgroup, so three tiles' stores overlap the
//    next tile's loads and products; an empty group's tiles are stores of
//    zeros with no loads.  The weight gradient sums over the group's
//    rows, 32 a stage: rows of a stage past the group's end (the next
//    group's) are zeroed in shared memory before wgmma reads them.
//
// f32: the first port's kernels, unchanged: FMA on the CUDA cores, each
// output a chain from zero over k (forward) or the group's rows (weight
// gradient) in increasing order, no TF32; 64 x 64 tiles through a
// 3-stage cp.async ring.
#include <cuda.h>  // CUtensorMap; the encoder is reached at run time

#include <cstdint>

#include "attn_common.cuh"

namespace {

// Rows [lo, hi) of group e; e == E is the tail past ends[E-1].
__device__ __forceinline__ int2 group_rows(const int* __restrict__ ends,
                                           int e, int E, int M) {
  int lo, hi;
  if (e == E) {
    lo = E ? ends[E - 1] : 0;
    hi = M;
  } else {
    lo = e ? ends[e - 1] : 0;
    hi = ends[e];
  }
  lo = min(max(lo, 0), M);
  hi = min(max(hi, lo), M);
  return make_int2(lo, hi);
}

// ===========================================================================
// f32: FMA on the CUDA cores
// ===========================================================================
constexpr int kThreads = 128;  // four warps
constexpr int kStages = 3;
constexpr int BM = 64;  // rows of a chunk (forward) / of dw's K tile
constexpr int BN = 64;  // output columns of a block
constexpr int BK = 32;  // contraction per stage (K forward, rows wgrad)
static_assert(BM == BN, "the weight gradient stages x and dy tiles alike");
constexpr int kMaxSplits = 16;  // blocks sharing one group's chunks

struct Pitch {  // one 16-byte chunk of padding: rows stay 16-byte aligned
  static constexpr int pad = 4;
  static constexpr int k = BK + pad;  // a row of BK
  static constexpr int n = BN + pad;  // a row of BN (or BM)
};

template <bool TRANS>
struct FwdSmem {
  static constexpr int XE = BM * Pitch::k;                     // x tile
  static constexpr int WE = TRANS ? BN * Pitch::k : BK * Pitch::n;
  static constexpr int kStageElems = XE + WE;
  static constexpr size_t kBytes = (size_t)kStages * kStageElems * 4;
};

// Copies stage `kt` (K columns kt * BK ..) of the chunk's first `rows`
// rows and of the weight tile into `st`; rows past `nrows`, columns past
// K and weight columns past N are zero-filled.  Every thread.
template <bool TRANS>
__device__ __forceinline__ void fwd_load(float* st, const float* __restrict__ x,
                                         const float* __restrict__ we, int r0,
                                         int nrows, int rows, int kt, int n0,
                                         int K, int N) {
  constexpr int C = 4;  // elements per copy
  constexpr int XP = Pitch::k;
  const int k0 = kt * BK;
  float* xs = st;
  float* ws = st + FwdSmem<TRANS>::XE;
  for (int i = threadIdx.x; i < rows * (BK / C); i += kThreads) {
    const int r = i / (BK / C), c = (i % (BK / C)) * C;
    const bool fill = r < nrows && k0 + c < K;
    cp_async16(xs + r * XP + c, fill ? x + (size_t)(r0 + r) * K + k0 + c : x,
               fill);
  }
  if constexpr (TRANS) {  // w[e] (N, K): rows n0 .., columns k0 ..
    for (int i = threadIdx.x; i < BN * (BK / C); i += kThreads) {
      const int n = i / (BK / C), c = (i % (BK / C)) * C;
      const bool fill = n0 + n < N && k0 + c < K;
      cp_async16(ws + n * XP + c,
                 fill ? we + (size_t)(n0 + n) * K + k0 + c : we, fill);
    }
  } else {  // w[e] (K, N): rows k0 .., columns n0 ..
    constexpr int WP = Pitch::n;
    for (int i = threadIdx.x; i < BK * (BN / C); i += kThreads) {
      const int k = i / (BN / C), c = (i % (BN / C)) * C;
      const bool fill = k0 + k < K && n0 + c < N;
      cp_async16(ws + k * WP + c,
                 fill ? we + (size_t)(k0 + k) * N + n0 + c : we, fill);
    }
  }
}

// Thread t holds rows t / 16 + 8 i (i < 8) and columns t % 16 + 16 j
// (j < 4) of the chunk's tile.
template <bool TRANS>
struct FwdFma {
  float acc[BM / 8][BN / 16];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
  }

  __device__ void compute(const float* st, int nrows) {
    constexpr int XP = Pitch::k;
    const float* xs = st;
    const float* ws = st + FwdSmem<TRANS>::XE;
    const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float b[BN / 16];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        b[j] = TRANS ? ws[(tc + 16 * j) * XP + k]
                     : ws[k * Pitch::n + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
        if (tr + 8 * i < nrows) {
          const float a = xs[(tr + 8 * i) * XP + k];
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
  }

  __device__ void store(float* __restrict__ y, int r0, int nrows, int n0,
                        int N) const {
    const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const int r = tr + 8 * i;
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const int n = n0 + tc + 16 * j;
        if (n < N) y[(size_t)(r0 + r) * N + n] = acc[i][j];
      }
    }
  }
};

template <bool TRANS>
__global__ void __launch_bounds__(kThreads)
    grouped_mm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int* __restrict__ ends, float* __restrict__ y,
                      int M, int K, int N, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr int SE = FwdSmem<TRANS>::kStageElems;
  const int e = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int2 rows = group_rows(ends, e, E, M);
  const int first = rows.x + blockIdx.z * BM, stride = gridDim.z * BM;
  if (first >= rows.y) return;  // an empty group, or no chunk for this split
  if (e == E) {                 // the rows past ends[E-1] are zero
    for (int r0 = first; r0 < rows.y; r0 += stride)
      for (int i = threadIdx.x; i < min(BM, rows.y - r0) * BN;
           i += kThreads) {
        const int r = r0 + i / BN, n = n0 + i % BN;
        if (n < N) y[(size_t)r * N + n] = 0.f;
      }
    return;
  }
  const float* we = w + (size_t)e * K * N;
  const int n_kt = (K + BK - 1) / BK;
  FwdFma<TRANS> acc;
  for (int r0 = first; r0 < rows.y; r0 += stride) {
    const int nrows = min(BM, rows.y - r0);
    const int mtiles = (nrows + 15) / 16;
    acc.zero();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_kt)
        fwd_load<TRANS>(smem + s * SE, x, we, r0, nrows, 16 * mtiles, s, n0,
                        K, N);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage kt landed; stage kt - 1 is free
      const int nxt = kt + kStages - 1;
      if (nxt < n_kt)
        fwd_load<TRANS>(smem + (nxt % kStages) * SE, x, we, r0, nrows,
                        16 * mtiles, nxt, n0, K, N);
      cp_async_commit();
      acc.compute(smem + (kt % kStages) * SE, nrows);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next chunk
    acc.store(y, r0, nrows, n0, N);
  }
}

struct WgradSmem {
  static constexpr int XE = BK * Pitch::n;     // 32 rows x 64 of K
  static constexpr int kStageElems = 2 * XE;   // and 32 rows x 64 of N
  static constexpr size_t kBytes = (size_t)kStages * kStageElems * 4;
};

// Copies rows r0 + 32 s .. of x (columns k0 ..) and dy (columns n0 ..);
// rows past hi and columns past K / N are zero-filled.  Every thread.
__device__ __forceinline__ void wgrad_load(float* st,
                                           const float* __restrict__ x,
                                           const float* __restrict__ dy,
                                           int r0, int hi, int k0, int n0,
                                           int K, int N) {
  constexpr int C = 4;
  constexpr int P = Pitch::n;
  float* xs = st;
  float* ds = st + WgradSmem::XE;
  for (int i = threadIdx.x; i < BK * (BN / C); i += kThreads) {
    const int r = i / (BN / C), c = (i % (BN / C)) * C;
    const bool in = r0 + r < hi;
    const bool fx = in && k0 + c < K, fd = in && n0 + c < N;
    cp_async16(xs + r * P + c, fx ? x + (size_t)(r0 + r) * K + k0 + c : x, fx);
    cp_async16(ds + r * P + c, fd ? dy + (size_t)(r0 + r) * N + n0 + c : dy,
               fd);
  }
}

// Thread t holds K rows t / 16 + 8 i (i < 8) and columns t % 16 + 16 j
// (j < 4); each sum an FMA chain over the group's rows in order.
struct WgradFma {
  float acc[BM / 8][BN / 16];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
  }

  __device__ void compute(const float* st, int nrows) {
    constexpr int P = Pitch::n;
    const float* xs = st;
    const float* ds = st + WgradSmem::XE;
    const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
    const int n = min(nrows, BK);
    for (int r = 0; r < n; ++r) {
      float a[BM / 8], b[BN / 16];
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) a[i] = xs[r * P + tr + 8 * i];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) b[j] = ds[r * P + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < BM / 8; ++i)
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ void store(float* __restrict__ dw, int k0, int n0, int K,
                        int N) const {
    const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const int k = k0 + tr + 8 * i;
      if (k >= K) continue;
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const int n = n0 + tc + 16 * j;
        if (n < N) dw[(size_t)k * N + n] = acc[i][j];
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
    grouped_mm_wgrad_kernel(const float* __restrict__ x,
                            const float* __restrict__ dy,
                            const int* __restrict__ ends,
                            float* __restrict__ dw, int M, int K, int N,
                            int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr int SE = WgradSmem::kStageElems;
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int2 rows = group_rows(ends, e, E, M);
  WgradFma acc;
  acc.zero();
  const int n_st = (rows.y - rows.x + BK - 1) / BK;  // 0: an empty group
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st)
      wgrad_load(smem + s * SE, x, dy, rows.x + s * BK, rows.y, k0, n0, K, N);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = st + kStages - 1;
    if (nxt < n_st)
      wgrad_load(smem + (nxt % kStages) * SE, x, dy, rows.x + nxt * BK,
                 rows.y, k0, n0, K, N);
    cp_async_commit();
    acc.compute(smem + (st % kStages) * SE, rows.y - rows.x - st * BK);
  }
  cp_async_wait<0>();
  acc.store(dw + (size_t)e * K * N, k0, n0, K, N);
}

template <bool TRANS>
int launch_fwd_f32(const void* x, const void* w, const int* ends, void* y,
                   int M, int K, int N, int E, cudaStream_t stream) {
  auto kernel = grouped_mm_kernel<TRANS>;
  const size_t smem = FwdSmem<TRANS>::kBytes;
  const cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int splits = min(kMaxSplits, max(1, (M + 127) / 128));
  const dim3 grid((N + BN - 1) / BN, E + 1, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), ends,
      static_cast<float*>(y), M, K, N, E);
  return (int)cudaGetLastError();
}

int launch_wgrad_f32(const void* x, const void* dy, const int* ends,
                     void* dw, int M, int K, int N, int E,
                     cudaStream_t stream) {
  auto kernel = grouped_mm_wgrad_kernel;
  const size_t smem = WgradSmem::kBytes;
  const cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), ends,
      static_cast<float*>(dw), M, K, N, E);
  return (int)cudaGetLastError();
}

// ===========================================================================
// bf16: TMA + wgmma (sm_90a)
// ===========================================================================
using bf16 = __nv_bfloat16;

constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kProducerWarp = 4 * kConsumers;       // the warp after them
constexpr int kTmaThreads = kConsumers * kWarpgroup + 32;
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16
constexpr int kAtom = 64;       // bf16 in one swizzled row

// Forward: a tile is kFwdCols weight columns (64 a warpgroup) by up to
// kFwdRows of a group's rows; kFwdK of K a stage.
constexpr int kFwdCols = 128, kFwdRows = 128, kFwdK = 64, kFwdStages = 5;
constexpr int kFwdA = kFwdCols * kRowBytes;   // 16 KB of weights a stage
constexpr int kFwdSlot = kFwdA + kFwdRows * kRowBytes;  // + up to 16 KB of x
constexpr int kYPitch = kAtom + 8;            // staged y row (bf16)
constexpr int kFwdStage = kFwdRows * kYPitch * 2;   // a warpgroup's staging
constexpr int kFwdBars = kFwdStages * kFwdSlot + kConsumers * kFwdStage;
constexpr size_t kFwdSmem = 1024 + kFwdBars + 2 * kFwdStages * 8;

// Weight gradient: a tile of dw is kWgTile of K (64 a warpgroup) by
// kWgTile of N; kWgRows of the group's rows a stage; kWgBufs staged
// tiles a warpgroup, so kWgBufs - 1 TMA stores stay in flight.
constexpr int kWgTile = 128, kWgRows = 32, kWgStages = 4, kWgBufs = 4;
constexpr int kWgBox = kWgRows * kRowBytes;   // 4 KB: 32 rows x 64 columns
constexpr int kWgSlot = 4 * kWgBox;           // x (2 boxes), then dy (2)
constexpr int kWgOutBox = 64 * kRowBytes;     // 8 KB: 64 of K x 64 of N
constexpr int kWgOut = 2 * kWgOutBox;         // a warpgroup's 64 x 128
constexpr int kWgBars = kWgStages * kWgSlot + kConsumers * kWgBufs * kWgOut;
constexpr size_t kWgSmem = 1024 + kWgBars + 2 * kWgStages * 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive, and expect `bytes` more of TMA traffic before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed.  No timeout: a trap
// would end the whole CUDA context, and a long stall need not be a
// deadlock (time slicing, a debugger).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// fetches a tensor map into the descriptor cache ahead of its first use
__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N committed store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until every committed store group has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's shared-memory writes before later TMA / wgmma
// (async proxy) accesses to them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// across the wgmma wait that completes it.
__device__ __forceinline__ void fence_acc(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle.  K-major operand
// (rows of 64 of K): lbo unused, sbo = 1024 (8 rows).  MN-major operand
// (rows of 64 of M or N, one row per k): lbo = bytes from one 64-column
// block to the next, sbo = 1024 (8 values of k).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x N, f32, the warpgroup's fragments) += A (64 x 16) B (16 x N),
// bf16; TA / TB: 1 when A / B is MN-major in shared memory.  Fragment i
// of a thread (warp w of the group, lane l) is row 16 w + l / 4 + 8 ((i
// / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma n");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}

// The 1024-byte aligned start of dynamic shared memory: its shared
// address, and its generic pointer.
struct SmemBase {
  uint32_t addr;
  unsigned char* ptr;
};

__device__ __forceinline__ SmemBase smem_base(unsigned char* raw) {
  const uint32_t a = smem_addr(raw);
  const uint32_t b = (a + 1023u) & ~1023u;
  return {b, raw + (b - a)};
}

// ---------------------------------------------------------------------------
// The forward's work list: kernels/grouped_mm.py tile_walk() is its plain
// specification.  Units come expert by expert (ascending); an expert with
// rows has ceil(rows / kFwdRows) row tiles x ceil(N / kFwdCols) column
// tiles x `splits` K splits, ordered column tile, then split, then row
// tile.  With splits == 1 the tail of rows past ends[E-1] follows as
// expert E (row tiles x column tiles of zeros); with splits > 1 the sum
// pass writes it.  CTA b takes units b, b + gridDim.x, ...
// ---------------------------------------------------------------------------
struct FwdUnit {
  int e, r0, r1, n0, kb0, kb1, split, box;
};

// Called by one thread of each CTA for every unit it takes, with the
// fields of tile_walk()'s WorkItem: a hook for the CPU emulation
// (tools/cuda_emu), which records the walk and holds it against
// tile_walk(); empty on the card.
#ifndef GROUPED_MM_TRACE_UNIT
#define GROUPED_MM_TRACE_UNIT(u, e, r0, r1, k0, k1, n0, n1, split, box)
#endif

struct FwdWalk {
  const int* __restrict__ ends;
  int M, N, E, splits, nkb, last;  // last: E with the tail, else E - 1
  int e = -1, end = 0, first = 0;  // current expert, its units [first, end)

  __device__ FwdWalk(const int* ends_, int M_, int K, int N_, int E_,
                     int splits_)
      : ends(ends_), M(M_), N(N_), E(E_), splits(splits_),
        nkb((K + kFwdK - 1) / kFwdK), last(splits_ == 1 ? E_ : E_ - 1) {}

  __device__ int2 rows(int g) const {
    int lo, hi;
    if (g == E) {
      lo = __ldg(ends + E - 1);
      hi = M;
    } else {
      lo = g ? __ldg(ends + g - 1) : 0;
      hi = __ldg(ends + g);
    }
    lo = min(max(lo, 0), M);
    return make_int2(lo, min(max(hi, lo), M));
  }

  __device__ int units(int g) const {
    const int2 r = rows(g);
    const int nrt = (r.y - r.x + kFwdRows - 1) / kFwdRows;
    return nrt * ((N + kFwdCols - 1) / kFwdCols) * (g == E ? 1 : splits);
  }

  // Warp-wide, every lane with the same u (never decreasing from call to
  // call): moves to the expert holding unit u, 32 experts a step; false
  // past the last unit.
  __device__ bool seek(int u) {
    const int lane = threadIdx.x & 31;
    while (u >= end) {
      if (e >= last) return false;
      const int g = e + 1 + lane;
      const int c = g <= last ? units(g) : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(ATTN_FULL_MASK, incl, o);
        if (lane >= o) incl += v;
      }
      const unsigned hit = __ballot_sync(ATTN_FULL_MASK, u < end + incl);
      if (hit) {
        const int L = __ffs(hit) - 1;
        const int incl_l = __shfl_sync(ATTN_FULL_MASK, incl, L);
        const int c_l = __shfl_sync(ATTN_FULL_MASK, c, L);
        e += 1 + L;
        first = end + incl_l - c_l;
        end += incl_l;
      } else {
        e += 32;
        end += __shfl_sync(ATTN_FULL_MASK, incl, 31);
        first = end;
      }
    }
    return true;
  }

  // Unit u of the current expert (after seek(u)).
  __device__ FwdUnit unit(int u) const {
    const int2 r = rows(e);
    const int nrt = (r.y - r.x + kFwdRows - 1) / kFwdRows;
    const int S = e == E ? 1 : splits;
    const int q = u - first;
    const int ct = q / (S * nrt), rem = q % (S * nrt);
    const int s = rem / nrt, rt = rem % nrt;
    FwdUnit t;
    t.e = e;
    t.r0 = r.x + rt * kFwdRows;
    t.r1 = min(t.r0 + kFwdRows, r.y);
    t.n0 = ct * kFwdCols;
    t.split = s;
    t.kb0 = s * nkb / S;
    t.kb1 = (s + 1) * nkb / S;
    const int n = t.r1 - t.r0;
    t.box = n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
    return t;
  }
};

struct FwdMaps {  // w, and x in boxes of 16 / 32 / 64 / 128 rows
  CUtensorMap w, x16, x32, x64, x128;
};

// One forward tile on consumer warpgroup `wg`: the K blocks of the unit's
// split, then its output (bf16 y through shared memory, or f32 partials).
template <int NB, bool TRANS>
__device__ __forceinline__ void fwd_tile(const FwdUnit& t, int wg,
                                         uint32_t ring, uint32_t bars,
                                         int& stage, uint32_t& phase,
                                         bf16* __restrict__ stg,
                                         bf16* __restrict__ y,
                                         float* __restrict__ part, int M,
                                         int N, int splits) {
  const int tid = threadIdx.x % kWarpgroup;
  const int w = tid / 32, l = tid % 32;
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int kb = t.kb0; kb < t.kb1; ++kb) {
    mbar_wait(bars + 8 * stage, phase);
    const uint32_t slot = ring + stage * kFwdSlot;
    const uint32_t a = slot + wg * (kFwdA / 2), b = slot + kFwdA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdK / 16; ++kk) {
      const uint64_t da = TRANS ? sw128_desc(a + 32 * kk, 16, 1024)
                                : sw128_desc(a + 2048 * kk, kFwdA / 2, 1024);
      wgmma<NB, TRANS ? 0 : 1, 0>(acc, da, sw128_desc(b + 32 * kk, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) fence_acc(acc[i]);
    if (tid == 0) mbar_arrive(bars + 8 * (kFwdStages + stage));
    if (++stage == kFwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // fragment i: weight column m, row n of the tile
  const int col0 = t.n0 + wg * kAtom;
  if (splits > 1) {
    float* p = part + (size_t)t.split * M * N;
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) {
      const int m = 16 * w + l / 4 + 8 * ((i / 2) % 2);
      const int r = t.r0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;
      if (r < t.r1 && col0 + m < N) p[(size_t)r * N + col0 + m] = acc[i];
    }
    return;
  }
  named_bar_sync(2 + wg, kWarpgroup);  // the staging rows are free
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) {
    const int m = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int n = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    stg[n * kYPitch + m] = __float2bfloat16(acc[i]);
  }
  named_bar_sync(2 + wg, kWarpgroup);
  for (int i = tid; i < (t.r1 - t.r0) * 8; i += kWarpgroup) {
    const int r = i / 8, c = col0 + 8 * (i % 8);
    if (c < N)
      *reinterpret_cast<uint4*>(y + (size_t)(t.r0 + r) * N + c) =
          *reinterpret_cast<const uint4*>(stg + r * kYPitch + 8 * (i % 8));
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(kTmaThreads, 1)
    grouped_mm_tma_kernel(const __grid_constant__ FwdMaps maps,
                          const int* __restrict__ ends, bf16* __restrict__ y,
                          float* __restrict__ part, int M, int K, int N,
                          int E, int splits) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const SmemBase sb = smem_base(smem_raw);
  const uint32_t ring = sb.addr, bars = sb.addr + kFwdBars;
  // full[s] = bars + 8 s (count 1 + bytes), empty[s] = bars + 8 (kFwdStages
  // + s) (one arrival per consumer warpgroup)
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kFwdStages + s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  FwdWalk walk(ends, M, K, N, E, splits);
  int stage = 0;
  uint32_t phase = 0;
  if (warp == kProducerWarp) {
    if (lane == 0) {
      prefetch_tmap(&maps.w);
      prefetch_tmap(&maps.x16);
      prefetch_tmap(&maps.x32);
      prefetch_tmap(&maps.x64);
      prefetch_tmap(&maps.x128);
    }
    for (int u = blockIdx.x; walk.seek(u); u += gridDim.x) {
      const FwdUnit t = walk.unit(u);
      if (lane == 0)
        GROUPED_MM_TRACE_UNIT(u, t.e, t.r0, t.r1,
                              t.e == E ? 0 : t.kb0 * kFwdK,
                              t.e == E ? 0 : min(t.kb1 * kFwdK, K), t.n0,
                              min(t.n0 + kFwdCols, N), t.split, t.box);
      if (t.e == E) continue;  // the tail: nothing to load
      const CUtensorMap* xm = t.box == 16   ? &maps.x16
                              : t.box == 32 ? &maps.x32
                              : t.box == 64 ? &maps.x64
                                            : &maps.x128;
      for (int kb = t.kb0; kb < t.kb1; ++kb) {
        if (lane == 0) {
          const uint32_t full = bars + 8 * stage;
          mbar_wait(bars + 8 * (kFwdStages + stage), phase ^ 1);
          const uint32_t slot = ring + stage * kFwdSlot;
          mbar_expect_tx(full, kFwdA + t.box * kRowBytes);
          if (TRANS) {  // w[e] (N, K): 128 rows of N, 64 of K
            tma_load_3d(slot, &maps.w, full, kb * kFwdK, t.n0, t.e);
          } else {      // w[e] (K, N): 64 rows of K, 2 x 64 columns of N
            tma_load_3d(slot, &maps.w, full, t.n0, kb * kFwdK, t.e);
            tma_load_3d(slot + kFwdA / 2, &maps.w, full, t.n0 + kAtom,
                        kb * kFwdK, t.e);
          }
          tma_load_2d(slot + kFwdA, xm, full, kb * kFwdK, t.r0);
        }
        if (++stage == kFwdStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else if (warp < kProducerWarp) {
    const int wg = warp / 4, tid = threadIdx.x % kWarpgroup;
    bf16* stg = reinterpret_cast<bf16*>(sb.ptr + kFwdStages * kFwdSlot +
                                        wg * kFwdStage);
    for (int u = blockIdx.x; walk.seek(u); u += gridDim.x) {
      const FwdUnit t = walk.unit(u);
      if (t.e == E) {  // zero rows past ends[E-1], this group's 64 columns
        const int col0 = t.n0 + wg * kAtom;
        for (int i = tid; i < (t.r1 - t.r0) * 8; i += kWarpgroup) {
          const int c = col0 + 8 * (i % 8);
          if (c < N)
            *reinterpret_cast<uint4*>(y + (size_t)(t.r0 + i / 8) * N + c) =
                make_uint4(0, 0, 0, 0);
        }
        continue;
      }
      switch (t.box) {
        case 16:
          fwd_tile<16, TRANS>(t, wg, ring, bars, stage, phase, stg, y, part,
                              M, N, splits);
          break;
        case 32:
          fwd_tile<32, TRANS>(t, wg, ring, bars, stage, phase, stg, y, part,
                              M, N, splits);
          break;
        case 64:
          fwd_tile<64, TRANS>(t, wg, ring, bars, stage, phase, stg, y, part,
                              M, N, splits);
          break;
        default:
          fwd_tile<128, TRANS>(t, wg, ring, bars, stage, phase, stg, y, part,
                               M, N, splits);
      }
    }
  }
}

// y = bf16(sum over splits of the f32 partials, in split order) below
// ends[E-1], zeros past it; 8 columns a thread.
__global__ void grouped_mm_sum_kernel(const float* __restrict__ part,
                                      const int* __restrict__ ends,
                                      bf16* __restrict__ y, int M, int N,
                                      int E, int splits) {
  const int used = min(max(__ldg(ends + E - 1), 0), M);
  const size_t chunks = (size_t)M * (N / 8);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < chunks;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / (N / 8), c = 8 * (i % (N / 8));
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if ((int)r < used)
      for (int k = 0; k < splits; ++k) {
        const float4* p = reinterpret_cast<const float4*>(
            part + ((size_t)k * M + r) * N + c);
        const float4 a = p[0], b = p[1];
        s[0] += a.x, s[1] += a.y, s[2] += a.z, s[3] += a.w;
        s[4] += b.x, s[5] += b.y, s[6] += b.z, s[7] += b.w;
      }
    uint4 o;
    o.x = pack_bf16(s[0], s[1]);
    o.y = pack_bf16(s[2], s[3]);
    o.z = pack_bf16(s[4], s[5]);
    o.w = pack_bf16(s[6], s[7]);
    *reinterpret_cast<uint4*>(y + r * N + c) = o;
  }
}

// ---------------------------------------------------------------------------
// The weight gradient's work list (tile_walk(..., wgrad=True)): unit u is
// expert u / (nkt nnt), then K tile, then N tile -- every expert has the
// same nkt x nnt tiles, an empty one all zeros.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kTmaThreads, 1)
    grouped_mm_wgrad_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                                const __grid_constant__ CUtensorMap dy_map,
                                const __grid_constant__ CUtensorMap dw_map,
                                const int* __restrict__ ends, int M, int K,
                                int N, int E) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const SmemBase sb = smem_base(smem_raw);
  const uint32_t ring = sb.addr, bars = sb.addr + kWgBars;
  const int out_off = kWgStages * kWgSlot;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kWgStages + s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nkt = (K + kWgTile - 1) / kWgTile, nnt = (N + kWgTile - 1) / kWgTile;
  const int units = E * nkt * nnt;
  int stage = 0;
  uint32_t phase = 0;
  if (warp == kProducerWarp) {
    if (lane != 0) return;
    prefetch_tmap(&x_map);
    prefetch_tmap(&dy_map);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int e = u / (nkt * nnt), q = u % (nkt * nnt);
      const int k0 = (q / nnt) * kWgTile, n0 = (q % nnt) * kWgTile;
      const int2 rows = group_rows(ends, e, E, M);
      GROUPED_MM_TRACE_UNIT(u, e, rows.x, rows.y, k0, min(k0 + kWgTile, K),
                            n0, min(n0 + kWgTile, N), 0, kWgRows);
      for (int r = rows.x; r < rows.y; r += kWgRows) {
        const uint32_t full = bars + 8 * stage;
        mbar_wait(bars + 8 * (kWgStages + stage), phase ^ 1);
        const uint32_t slot = ring + stage * kWgSlot;
        mbar_expect_tx(full, kWgSlot);
        tma_load_2d(slot, &x_map, full, k0, r);
        tma_load_2d(slot + kWgBox, &x_map, full, k0 + kAtom, r);
        tma_load_2d(slot + 2 * kWgBox, &dy_map, full, n0, r);
        tma_load_2d(slot + 3 * kWgBox, &dy_map, full, n0 + kAtom, r);
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else if (warp < kProducerWarp) {
    const int wg = warp / 4, tid = threadIdx.x % kWarpgroup;
    const int w = tid / 32, l = tid % 32;
    int buf = 0;
    for (int u = blockIdx.x; u < units;
         u += gridDim.x, buf = (buf + 1) % kWgBufs) {
      const int e = u / (nkt * nnt), q = u % (nkt * nnt);
      const int k0 = (q / nnt) * kWgTile, n0 = (q % nnt) * kWgTile;
      const int2 rows = group_rows(ends, e, E, M);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int r = rows.x; r < rows.y; r += kWgRows) {
        mbar_wait(bars + 8 * stage, phase);
        const uint32_t slot = ring + stage * kWgSlot;
        const int valid = rows.y - r;
        if (valid < kWgRows) {
          // rows past the group's end belong to the next group: zero them
          // in this warpgroup's x box and dy box before wgmma reads them
          unsigned char* s = sb.ptr + stage * kWgSlot;
          for (int i = tid; i < (kWgRows - valid) * 8; i += kWarpgroup) {
            const int off = (valid + i / 8) * kRowBytes + 16 * (i % 8);
            *reinterpret_cast<uint4*>(s + wg * kWgBox + off) =
                make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(s + (2 + wg) * kWgBox + off) =
                make_uint4(0, 0, 0, 0);
          }
          fence_proxy_async();
          named_bar_sync(1, kConsumers * kWarpgroup);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgRows / 16; ++kk)
          wgmma<128, 1, 1>(
              acc, sw128_desc(slot + wg * kWgBox + 2048 * kk, kWgBox, 1024),
              sw128_desc(slot + 2 * kWgBox + 2048 * kk, kWgBox, 1024));
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_acc(acc[i]);
        if (tid == 0) mbar_arrive(bars + 8 * (kWgStages + stage));
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // dw rows k0 + 64 wg + m, columns n0 + n: staged in the 128-byte
      // swizzle the store map reads (16-byte chunk c of row m at c ^ m % 8)
      if (tid == 0) bulk_wait_read<kWgBufs - 1>();  // this buffer is free
      named_bar_sync(2 + wg, kWarpgroup);
      const int off = out_off + (kWgBufs * wg + buf) * kWgOut;
      unsigned char* o = sb.ptr + off;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int m = 16 * w + l / 4 + 8 * ((i / 2) % 2);
        const int j = i / 4;  // column block of 8: n = 8 j + 2 (l % 4)
        *reinterpret_cast<uint32_t*>(
            o + (j / 8) * kWgOutBox + m * kRowBytes +
            16 * ((j % 8) ^ (m % 8)) + 4 * (l % 4)) =
            pack_bf16(acc[i], acc[i + 1]);
      }
      fence_proxy_async();
      named_bar_sync(2 + wg, kWarpgroup);
      if (tid == 0) {
        tma_store_3d(&dw_map, sb.addr + off, n0, k0 + wg * kAtom, e);
        tma_store_3d(&dw_map, sb.addr + off + kWgOutBox, n0 + kAtom,
                     k0 + wg * kAtom, e);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_all();
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, encoded at each launch (the pointers change from
// call to call; encoding is host work with no device sync) through the
// driver's entry point, so the library needs no -lcuda.  The C entry
// point, five encodes and the launches, takes 9-18 us of host time at the
// MoE decode shapes (tools/gmm_host_time.py on an H100's host), and
// keeping the maps across calls saved nothing measurable.
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a row-major bf16 tensor of `rank` dims (dims innermost
// first), boxes of `box`, 128-byte swizzle, zeros outside the tensor.
bool make_map(CUtensorMap* map, const void* base, int rank,
              const uint64_t* dims, const uint32_t* box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  cuuint64_t gdim[3], stride[2];
  cuuint32_t bdim[3], estride[3] = {1, 1, 1};
  uint64_t s = sizeof(bf16);
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    if (i) stride[i - 1] = s;
    s *= dims[i];
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), gdim, stride, bdim, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TRANS>
int launch_fwd_bf16(const void* x, const void* w, const int* ends, void* y,
                    void* part, int M, int K, int N, int E, int splits,
                    int ctas, cudaStream_t stream) {
  FwdMaps maps;
  const uint64_t wd[3] = {TRANS ? (uint64_t)K : (uint64_t)N,
                          TRANS ? (uint64_t)N : (uint64_t)K, (uint64_t)E};
  const uint32_t wb[3] = {kAtom, TRANS ? (uint32_t)kFwdCols : (uint32_t)kFwdK,
                          1};
  const uint64_t xd[2] = {(uint64_t)K, (uint64_t)M};
  const uint32_t b16[2] = {kAtom, 16}, b32[2] = {kAtom, 32},
                 b64[2] = {kAtom, 64}, b128[2] = {kAtom, 128};
  if (!make_map(&maps.w, w, 3, wd, wb) || !make_map(&maps.x16, x, 2, xd, b16) ||
      !make_map(&maps.x32, x, 2, xd, b32) ||
      !make_map(&maps.x64, x, 2, xd, b64) ||
      !make_map(&maps.x128, x, 2, xd, b128))
    return (int)cudaErrorInvalidValue;
  auto kernel = grouped_mm_tma_kernel<TRANS>;
  const cudaError_t err = attn_set_smem(kernel, kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, kTmaThreads, kFwdSmem, stream>>>(
      maps, ends, static_cast<bf16*>(y), static_cast<float*>(part), M, K, N,
      E, splits);
  if (splits > 1) {
    const int chunks = (int)min((size_t)M * (N / 8), (size_t)1 << 30);
    grouped_mm_sum_kernel<<<min((chunks + 255) / 256, 4096), 256, 0,
                            stream>>>(static_cast<const float*>(part), ends,
                                      static_cast<bf16*>(y), M, N, E,
                                      splits);
  }
  return (int)cudaGetLastError();
}

int launch_wgrad_bf16(const void* x, const void* dy, const int* ends,
                      void* dw, int M, int K, int N, int E, int ctas,
                      cudaStream_t stream) {
  if (M == 0)  // every group empty
    return (int)cudaMemsetAsync(dw, 0, (size_t)E * K * N * sizeof(bf16),
                                stream);
  CUtensorMap xm, dym, dwm;
  const uint64_t xd[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t dyd[2] = {(uint64_t)N, (uint64_t)M};
  const uint64_t dwd[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint32_t in_box[2] = {kAtom, kWgRows}, out_box[3] = {kAtom, 64, 1};
  if (!make_map(&xm, x, 2, xd, in_box) || !make_map(&dym, dy, 2, dyd, in_box) ||
      !make_map(&dwm, dw, 3, dwd, out_box))
    return (int)cudaErrorInvalidValue;
  auto kernel = grouped_mm_wgrad_tma_kernel;
  const cudaError_t err = attn_set_smem(kernel, kWgSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, kTmaThreads, kWgSmem, stream>>>(xm, dym, dwm, ends, M, K, N,
                                                 E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (M, N) = the grouped product of x (M, K) with w (E, K, N), or with
// w (E, N, K) read transposed when trans != 0.  K and N: multiples of 8.
// bf16: `ctas` CTAs, K in `splits` parts; with splits > 1, `part` holds
// splits x M x N f32 partials.  f32 ignores part, splits and ctas.
int grouped_mm_launch(const void* x, const void* w, const int* ends, void* y,
                      void* part, int M, int K, int N, int E, int trans,
                      int dtype, int splits, int ctas, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8 || E > 65534)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ATTN_F32)
    return trans ? launch_fwd_f32<true>(x, w, ends, y, M, K, N, E, s)
                 : launch_fwd_f32<false>(x, w, ends, y, M, K, N, E, s);
  if (dtype != ATTN_BF16 || splits < 1 || ctas < 1 ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  return trans ? launch_fwd_bf16<true>(x, w, ends, y, part, M, K, N, E,
                                       splits, ctas, s)
               : launch_fwd_bf16<false>(x, w, ends, y, part, M, K, N, E,
                                        splits, ctas, s);
}

// dw (E, K, N): per group, x[group]^T dy[group]; x (M, K), dy (M, N).
// bf16: `ctas` CTAs; f32 ignores it.
int grouped_mm_wgrad_launch(const void* x, const void* dy, const int* ends,
                            void* dw, int M, int K, int N, int E, int dtype,
                            int ctas, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ATTN_F32)
    return launch_wgrad_f32(x, dy, ends, dw, M, K, N, E, s);
  if (dtype != ATTN_BF16 || ctas < 1) return (int)cudaErrorInvalidValue;
  return launch_wgrad_bf16(x, dy, ends, dw, M, K, N, E, ctas, s);
}

}  // extern "C"
