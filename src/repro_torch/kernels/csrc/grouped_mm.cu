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
// the host never waits for them, and both grids come from the shapes
// alone (E, K, N and M).
//
// Why this layout.  The MoE shapes on the card are bound by the experts'
// weight bytes (qwen3-moe's 256-token prefill puts ~16 rows on each of
// 128 experts; its 4-slot decode 32 rows on at most 32 of them).  One
// block per (expert, 64-column tile) streams its expert's K x 64 weight
// tile once per 64-row chunk of the group -- once in all for groups of up
// to 64 rows -- where a grid over row tiles would read an expert's
// weights once per tile its rows straddle.  But one expert can hold far
// more rows: a bucketed prefill's padding rows are all one token, so they
// all pick the same k experts.  So the grid has `splits` blocks per
// (expert, tile), from M alone (1 up to 128 rows, at most 16), and split
// s takes chunks s, s + splits, ...; a block with no chunk exits at once,
// as does one whose group is empty.  One more row of blocks (e = E)
// writes the zero rows past ends[E-1].
//
// Tiles come in through a 3-stage cp.async ring, 32 of K per stage.
// bf16: mma.sync m16n8k16 (f32 accumulate) fed by ldmatrix; warp w owns
// columns 16 w .. 16 w + 15 of the tile and every 16-row m-tile that
// holds a row of the chunk.  f32: FMA on the CUDA cores, each output a
// chain from zero over k in increasing order (no TF32).  The weight
// gradient: one block per (expert, 64-row K tile, 64-column N tile),
// summing its group's rows in increasing order, 32 a stage.  Every output
// element is written by one block, with no atomics and no split of the
// sum, so a second call gives the same bits.
#include <type_traits>

#include "attn_common.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kStages = 3;
constexpr int BM = 64;  // rows of a chunk (forward) / of dw's K tile
constexpr int BN = 64;  // output columns of a block
constexpr int BK = 32;  // contraction per stage (K forward, rows wgrad)
static_assert(BM == BN, "the weight gradient stages x and dy tiles alike");
constexpr int kMaxSplits = 16;  // blocks sharing one group's chunks

template <typename T>
struct Pitch {  // one 16-byte chunk of padding: rows stay 16-byte aligned
  static constexpr int pad = 16 / (int)sizeof(T);
  static constexpr int k = BK + pad;  // a row of BK
  static constexpr int n = BN + pad;  // a row of BN (or BM)
};

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

// ---------------------------------------------------------------------------
// Forward (and input gradient): y = x w[e] (or x w[e]^T)
// ---------------------------------------------------------------------------
template <typename T, bool TRANS>
struct FwdSmem {
  static constexpr int XE = BM * Pitch<T>::k;                     // x tile
  static constexpr int WE = TRANS ? BN * Pitch<T>::k : BK * Pitch<T>::n;
  static constexpr int kStageElems = XE + WE;
  static constexpr size_t kBytes = (size_t)kStages * kStageElems * sizeof(T);
};

// Copies stage `kt` (K columns kt * BK ..) of the chunk's first `rows`
// rows and of the weight tile into `st`; rows past `nrows`, columns past
// K and weight columns past N are zero-filled.  Every thread.
template <typename T, bool TRANS>
__device__ __forceinline__ void fwd_load(T* st, const T* __restrict__ x,
                                         const T* __restrict__ we, int r0,
                                         int nrows, int rows, int kt, int n0,
                                         int K, int N) {
  constexpr int C = 16 / (int)sizeof(T);  // elements per copy
  constexpr int XP = Pitch<T>::k;
  const int k0 = kt * BK;
  T* xs = st;
  T* ws = st + FwdSmem<T, TRANS>::XE;
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
    constexpr int WP = Pitch<T>::n;
    for (int i = threadIdx.x; i < BK * (BN / C); i += kThreads) {
      const int k = i / (BN / C), c = (i % (BN / C)) * C;
      const bool fill = k0 + k < K && n0 + c < N;
      cp_async16(ws + k * WP + c,
                 fill ? we + (size_t)(k0 + k) * N + n0 + c : we, fill);
    }
  }
}

// bf16 accumulators: m-tile mt (rows 16 mt ..), n-fragment f (columns
// 16 warp + 8 f ..); this lane holds rows lane / 4 (+ 8) and columns
// 2 (lane % 4) (+ 1) of each, as the mma C fragment lays them out.
template <bool TRANS>
struct FwdMma {
  using T = __nv_bfloat16;
  float acc[BM / 16][2][4];

  __device__ void zero() {
#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][f][i] = 0.f;
  }

  __device__ void compute(const T* st, int mtiles) {
    constexpr int XP = Pitch<T>::k;
    const T* xs = st;
    const T* ws = st + FwdSmem<T, TRANS>::XE;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mat = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      unsigned b0, b1, b2, b3;
      if constexpr (TRANS) {  // stored [n][k]: as K in Q K^T
        const int n = 16 * warp + 8 * (mat >> 1) + (lane & 7);
        ldsm_x4(ws + n * XP + 16 * ks + 8 * (mat & 1), b0, b1, b2, b3);
      } else {  // stored [k][n]: as V in P V
        const int k = 16 * ks + 8 * (mat & 1) + (lane & 7);
        ldsm_x4_trans(ws + k * Pitch<T>::n + 16 * warp + 8 * (mat >> 1), b0,
                      b1, b2, b3);
      }
#pragma unroll
      for (int mt = 0; mt < BM / 16; ++mt) {
        if (mt < mtiles) {
          unsigned a[4];
          const int r = 16 * mt + 8 * (mat & 1) + (lane & 7);
          ldsm_x4(xs + r * XP + 16 * ks + 8 * (mat >> 1), a[0], a[1], a[2],
                  a[3]);
          mma_bf16(acc[mt][0], a, b0, b1);
          mma_bf16(acc[mt][1], a, b2, b3);
        }
      }
    }
  }

  __device__ void store(T* __restrict__ y, int r0, int nrows, int mtiles,
                        int n0, int N) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt) {
      if (mt >= mtiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + (lane >> 2) + 8 * h;
        if (r >= nrows) continue;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int n = n0 + 16 * warp + 8 * f + 2 * (lane & 3);
          if (n < N)
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(r0 + r) * N + n) =
                __floats2bfloat162_rn(acc[mt][f][2 * h],
                                      acc[mt][f][2 * h + 1]);
        }
      }
    }
  }
};

// f32 accumulators: thread t holds rows t / 16 + 8 i (i < 8) and columns
// t % 16 + 16 j (j < 4) of the chunk's tile.
template <bool TRANS>
struct FwdFma {
  using T = float;
  float acc[BM / 8][BN / 16];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
  }

  __device__ void compute(const T* st, int /*mtiles*/, int nrows) {
    constexpr int XP = Pitch<T>::k;
    const T* xs = st;
    const T* ws = st + FwdSmem<T, TRANS>::XE;
    const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float b[BN / 16];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        b[j] = TRANS ? ws[(tc + 16 * j) * XP + k]
                     : ws[k * Pitch<T>::n + tc + 16 * j];
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

  __device__ void store(T* __restrict__ y, int r0, int nrows, int /*mtiles*/,
                        int n0, int N) const {
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

template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads)
    grouped_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ ends, T* __restrict__ y, int M,
                      int K, int N, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int SE = FwdSmem<T, TRANS>::kStageElems;
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
        if (n < N) y[(size_t)r * N + n] = from_f32<T>(0.f);
      }
    return;
  }
  const T* we = w + (size_t)e * K * N;
  const int n_kt = (K + BK - 1) / BK;
  using Acc = std::conditional_t<std::is_same<T, float>::value, FwdFma<TRANS>,
                                 FwdMma<TRANS>>;
  Acc acc;
  for (int r0 = first; r0 < rows.y; r0 += stride) {
    const int nrows = min(BM, rows.y - r0);
    const int mtiles = (nrows + 15) / 16;
    acc.zero();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_kt)
        fwd_load<T, TRANS>(smem + s * SE, x, we, r0, nrows, 16 * mtiles, s,
                           n0, K, N);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage kt landed; stage kt - 1 is free
      const int nxt = kt + kStages - 1;
      if (nxt < n_kt)
        fwd_load<T, TRANS>(smem + (nxt % kStages) * SE, x, we, r0, nrows,
                           16 * mtiles, nxt, n0, K, N);
      cp_async_commit();
      if constexpr (std::is_same<T, float>::value)
        acc.compute(smem + (kt % kStages) * SE, mtiles, nrows);
      else
        acc.compute(smem + (kt % kStages) * SE, mtiles);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next chunk
    acc.store(y, r0, nrows, mtiles, n0, N);
  }
}

// ---------------------------------------------------------------------------
// Weight gradient: dw[e] (K, N) = x[group e]^T dy[group e]
// ---------------------------------------------------------------------------
template <typename T>
struct WgradSmem {
  static constexpr int XE = BK * Pitch<T>::n;  // 32 rows x 64 of K
  static constexpr int kStageElems = 2 * XE;   // and 32 rows x 64 of N
  static constexpr size_t kBytes = (size_t)kStages * kStageElems * sizeof(T);
};

// Copies rows r0 + 32 s .. of x (columns k0 ..) and dy (columns n0 ..);
// rows past hi and columns past K / N are zero-filled.  Every thread.
template <typename T>
__device__ __forceinline__ void wgrad_load(T* st, const T* __restrict__ x,
                                           const T* __restrict__ dy, int r0,
                                           int hi, int k0, int n0, int K,
                                           int N) {
  constexpr int C = 16 / (int)sizeof(T);
  constexpr int P = Pitch<T>::n;
  T* xs = st;
  T* ds = st + WgradSmem<T>::XE;
  for (int i = threadIdx.x; i < BK * (BN / C); i += kThreads) {
    const int r = i / (BN / C), c = (i % (BN / C)) * C;
    const bool in = r0 + r < hi;
    const bool fx = in && k0 + c < K, fd = in && n0 + c < N;
    cp_async16(xs + r * P + c, fx ? x + (size_t)(r0 + r) * K + k0 + c : x, fx);
    cp_async16(ds + r * P + c, fd ? dy + (size_t)(r0 + r) * N + n0 + c : dy,
               fd);
  }
}

// bf16: warp w owns K rows 16 w .. 16 w + 15 of the tile and all 64
// columns (eight n-fragments); A = x^T comes from the [row][k] stage by
// ldmatrix.trans, B = dy from the [row][n] stage likewise.
struct WgradMma {
  using T = __nv_bfloat16;
  float acc[BN / 8][4];

  __device__ void zero() {
#pragma unroll
    for (int f = 0; f < BN / 8; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][i] = 0.f;
  }

  __device__ void compute(const T* st, int nrows) {
    constexpr int P = Pitch<T>::n;
    const T* xs = st;
    const T* ds = st + WgradSmem<T>::XE;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mat = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (16 * ks >= nrows) break;
      unsigned a[4];
      const int ra = 16 * ks + 8 * (mat >> 1) + (lane & 7);
      ldsm_x4_trans(xs + ra * P + 16 * warp + 8 * (mat & 1), a[0], a[1], a[2],
                    a[3]);
      const int rb = 16 * ks + 8 * (mat & 1) + (lane & 7);
#pragma unroll
      for (int nd = 0; nd < BN / 16; ++nd) {
        unsigned b0, b1, b2, b3;
        ldsm_x4_trans(ds + rb * P + 8 * (2 * nd + (mat >> 1)), b0, b1, b2, b3);
        mma_bf16(acc[2 * nd], a, b0, b1);
        mma_bf16(acc[2 * nd + 1], a, b2, b3);
      }
    }
  }

  __device__ void store(T* __restrict__ dw, int k0, int n0, int K,
                        int N) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 16 * warp + (lane >> 2) + 8 * h;
      if (k >= K) continue;
#pragma unroll
      for (int f = 0; f < BN / 8; ++f) {
        const int n = n0 + 8 * f + 2 * (lane & 3);
        if (n < N)
          *reinterpret_cast<__nv_bfloat162*>(dw + (size_t)k * N + n) =
              __floats2bfloat162_rn(acc[f][2 * h], acc[f][2 * h + 1]);
      }
    }
  }
};

// f32: thread t holds K rows t / 16 + 8 i (i < 8) and columns t % 16 +
// 16 j (j < 4); each sum an FMA chain over the group's rows in order.
struct WgradFma {
  using T = float;
  float acc[BM / 8][BN / 16];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
  }

  __device__ void compute(const T* st, int nrows) {
    constexpr int P = Pitch<T>::n;
    const T* xs = st;
    const T* ds = st + WgradSmem<T>::XE;
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

  __device__ void store(T* __restrict__ dw, int k0, int n0, int K,
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_mm_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const int* __restrict__ ends, T* __restrict__ dw,
                            int M, int K, int N, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int SE = WgradSmem<T>::kStageElems;
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int2 rows = group_rows(ends, e, E, M);
  using Acc = std::conditional_t<std::is_same<T, float>::value, WgradFma,
                                 WgradMma>;
  Acc acc;
  acc.zero();
  const int n_st = (rows.y - rows.x + BK - 1) / BK;  // 0: an empty group
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st)
      wgrad_load<T>(smem + s * SE, x, dy, rows.x + s * BK, rows.y, k0, n0, K,
                    N);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = st + kStages - 1;
    if (nxt < n_st)
      wgrad_load<T>(smem + (nxt % kStages) * SE, x, dy, rows.x + nxt * BK,
                    rows.y, k0, n0, K, N);
    cp_async_commit();
    acc.compute(smem + (st % kStages) * SE, rows.y - rows.x - st * BK);
  }
  cp_async_wait<0>();
  acc.store(dw + (size_t)e * K * N, k0, n0, K, N);
}

template <typename T, bool TRANS>
int launch_fwd(const void* x, const void* w, const int* ends, void* y, int M,
               int K, int N, int E, cudaStream_t stream) {
  auto kernel = grouped_mm_kernel<T, TRANS>;
  const size_t smem = FwdSmem<T, TRANS>::kBytes;
  const cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int splits = min(kMaxSplits, max(1, (M + 127) / 128));
  const dim3 grid((N + BN - 1) / BN, E + 1, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), ends,
      static_cast<T*>(y), M, K, N, E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const void* x, const void* dy, const int* ends, void* dw,
                 int M, int K, int N, int E, cudaStream_t stream) {
  auto kernel = grouped_mm_wgrad_kernel<T>;
  const size_t smem = WgradSmem<T>::kBytes;
  const cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ends,
      static_cast<T*>(dw), M, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (M, N) = the grouped product of x (M, K) with w (E, K, N), or with
// w (E, N, K) read transposed when trans != 0.  K and N: multiples of 8.
int grouped_mm_launch(const void* x, const void* w, const int* ends, void* y,
                      int M, int K, int N, int E, int trans, int dtype,
                      void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8 || E > 65534)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH_DTYPE(dtype, {
    return trans ? launch_fwd<T, true>(x, w, ends, y, M, K, N, E, s)
                 : launch_fwd<T, false>(x, w, ends, y, M, K, N, E, s);
  });
  return (int)cudaErrorInvalidValue;
}

// dw (E, K, N): per group, x[group]^T dy[group]; x (M, K), dy (M, N).
int grouped_mm_wgrad_launch(const void* x, const void* dy, const int* ends,
                            void* dw, int M, int K, int N, int E, int dtype,
                            void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH_DTYPE(dtype,
                      { return launch_wgrad<T>(x, dy, ends, dw, M, K, N, E, s); });
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
