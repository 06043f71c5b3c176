// Shared helpers for the hand-written Hopper attention kernels.
//
// Every kernel is templated over the element type (float or
// __nv_bfloat16) and the head dim (16, 32, 64, 80 or 128; 80 is zamba2's
// shared attention block, 2560 / 32): a multiple of 16, so a row is whole
// 16-byte copies and whole 16-wide mma k-steps.  Softmax state and
// accumulators are f32.  The masking constant and the l == 0 -> 1 guard follow
// the reference kernels exactly, so a fully masked query row comes out
// as 0, never NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ATTN_NEG_INF (-1e30f)
#define ATTN_FULL_MASK 0xffffffffu

enum AttnDtype { ATTN_F32 = 0, ATTN_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of a staged row (four f32 or eight bf16 values) as f32
__device__ __forceinline__ void chunk_f32(const float* p, float* x) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p, float* x) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(ATTN_FULL_MASK, x, o));
  return x;
}

// Butterfly sum: every lane ends with the bitwise-same value, because
// each level adds the same two operands (in swapped order) on both lanes.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(ATTN_FULL_MASK, x, o);
  return x;
}

// Shared-memory row pitch (in elements) of a K tile: one extra 32-bit
// word per row, so lanes that each read their own key row hit distinct
// banks.
template <typename T, int HD>
struct KPitch {
  static constexpr int value = HD + 4 / (int)sizeof(T);
};

// Row pitch (in elements) of a K or V row in the cp.async tile ring: one
// extra 16-byte chunk per row.  A row then starts on a 16-byte boundary
// (what cp.async and ldmatrix need), and a row is an odd number of
// 16-byte chunks long for every supported (T, HD), so eight lanes that
// each read 16 bytes of their own row -- or the eight row addresses of
// one ldmatrix 8x8 matrix -- fall in eight distinct bank groups.
template <typename T, int HD>
struct RingPitch {
  static constexpr int value = HD + 16 / (int)sizeof(T);
};

// Runs BODY with the compile-time head dim HD; unsupported dims fail the
// launch with cudaErrorInvalidValue.
#define ATTN_DISPATCH_HD(hd, ...)                  \
  switch (hd) {                                    \
    case 16: {                                     \
      constexpr int HD = 16;                       \
      __VA_ARGS__;                                 \
    } break;                                       \
    case 32: {                                     \
      constexpr int HD = 32;                       \
      __VA_ARGS__;                                 \
    } break;                                       \
    case 64: {                                     \
      constexpr int HD = 64;                       \
      __VA_ARGS__;                                 \
    } break;                                       \
    case 80: {                                     \
      constexpr int HD = 80;                       \
      __VA_ARGS__;                                 \
    } break;                                       \
    case 128: {                                    \
      constexpr int HD = 128;                      \
      __VA_ARGS__;                                 \
    } break;                                       \
    default:                                       \
      return (int)cudaErrorInvalidValue;           \
  }

// Runs BODY with the element type T chosen by an AttnDtype code.
#define ATTN_DISPATCH_DTYPE(dtype, ...)            \
  if ((dtype) == ATTN_F32) {                       \
    using T = float;                               \
    __VA_ARGS__;                                   \
  } else if ((dtype) == ATTN_BF16) {               \
    using T = __nv_bfloat16;                       \
    __VA_ARGS__;                                   \
  } else {                                         \
    return (int)cudaErrorInvalidValue;             \
  }

// Opt a kernel into more than 48 KB of dynamic shared memory when it
// needs it; returns the launch error code (0 on success).
template <typename Kernel>
inline cudaError_t attn_set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// KV addressing policies.  The decode and partial-prefill kernels walk a
// range of virtual key indices s in [lo(), hi()) of one (slot, kv head)
// and differ only in where key s lives; each kernel is templated over one
// of these.  bind() runs once per block, before the kernel's first
// __syncthreads(); position(s) is -1 for a key that must not be read;
// position_ptr(s) and row(s) are only formed for a key that may be read.
// kCutsList: the dense layout cuts the block's needed-tile list into
// gridDim's split count of equal shares (split-KV chosen by the host);
// the paged layout's splits are already the reference's table ranges, so
// a paged block walks its whole list.
// ---------------------------------------------------------------------------

// Dense cache: k, v (B', S, nkv, hd); positions (B', S).  Query slot b
// reads cache row slots[b] when a slot index is given (a forward over
// some of the cache's slots), else row b (B' = B).
struct DenseKV {
  static constexpr bool kCutsList = true;
  const int* pos;
  int S, nkv;
  const int* slots;  // nullable
  int b_, kvh_;

  static int table_ints(int /*split_entries*/) { return 0; }
  __device__ void bind(int b, int kvh, int /*split*/, int* /*tbl_s*/) {
    b_ = slots ? slots[b] : b;
    kvh_ = kvh;
  }
  __device__ int lo() const { return 0; }
  __device__ int hi() const { return S; }
  __device__ const int* position_ptr(int s) const {
    return pos + (size_t)b_ * S + s;
  }
  __device__ int position(int s) const { return *position_ptr(s); }
  // element offset / HD of key s of this block's kv head
  __device__ size_t row(int s) const {
    return ((size_t)b_ * S + s) * nkv + kvh_;
  }
};

// Paged pool: k, v (nb, bs, nkv, hd); positions (nb, bs); block tables
// (B, max_bps), -1 = unmapped.  Virtual key s of a slot lives in pool
// block table[b, s / bs], row s % bs.  Split `split` owns table entries
// [split * split_entries, (split + 1) * split_entries) -- the reference's
// fused_layout ranges -- clipped to the table.  bind() copies those
// entries into shared memory, so the dependent load (entry, then row)
// pays its latency once per block instead of once per tile.  Unmapped
// entries read as position -1: their K/V is never loaded.
struct PagedKV {
  static constexpr bool kCutsList = false;
  const int* pos;
  const int* tables;
  int bs, max_bps, nkv, split_entries;
  int kvh_, e0_, hi_;
  const int* tbl_;

  static int table_ints(int split_entries) { return split_entries; }
  __device__ void bind(int b, int kvh, int split, int* tbl_s) {
    kvh_ = kvh;
    e0_ = split * split_entries;
    const int n = max(0, min(split_entries, max_bps - e0_));
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      tbl_s[i] = tables[(size_t)b * max_bps + e0_ + i];
    tbl_ = tbl_s;
    hi_ = (e0_ + n) * bs;
  }
  __device__ int lo() const { return e0_ * bs; }
  __device__ int hi() const { return hi_; }
  __device__ int block(int s) const { return tbl_[s / bs - e0_]; }
  __device__ const int* position_ptr(int s) const {
    return pos + (size_t)block(s) * bs + s % bs;
  }
  __device__ int position(int s) const {
    return block(s) < 0 ? -1 : *position_ptr(s);
  }
  __device__ size_t row(int s) const {
    return ((size_t)block(s) * bs + s % bs) * nkv + kvh_;
  }
};

// ---------------------------------------------------------------------------
// The needed-tile walk.  Keys are taken in tiles of 32.  A block first
// reads the int32 positions of its whole key range (4 bytes a key, one
// coalesced 128-byte load per warp and tile, four tiles in flight per
// warp) and keeps, per tile, the ballot of the keys that some row of the
// block may see: kp >= 0, kp <= qmax and, with a window, kp > qmin -
// window.  A key outside that ballot is masked for every row, so its K/V
// is never read.  Warp 0 then compacts the tiles with a non-empty ballot
// into a list, in key order.  The tile loop walks only that list.
// ---------------------------------------------------------------------------
constexpr int kTileKeys = 32;

__device__ __forceinline__ bool key_needed(int kp, int qmin, int qmax,
                                           int window) {
  return kp >= 0 && kp <= qmax && (window == 0 || kp > qmin - window);
}

// The per-row mask: a query row at position qp (-1 = padded) sees key kp
__device__ __forceinline__ bool row_sees(int kp, int qp, int window) {
  return kp >= 0 && qp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
}

// Fills mask_s[t] (ballot of tile t, n_tiles entries) and list_s (the
// tiles with a non-zero ballot); returns the list's length.  Called by
// every thread of the block (it contains barriers); qmax >= 0.
template <typename KV>
__device__ int build_tile_list(const KV& kv, int qmin, int qmax, int window,
                               unsigned* mask_s, int* list_s, int* n_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lo = kv.lo(), hi = kv.hi();
  const int n_tiles = (hi - lo + kTileKeys - 1) / kTileKeys;
  constexpr int kInFlight = 4;
  for (int t0 = warp; t0 < n_tiles; t0 += nwarps * kInFlight) {
    int kp[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int t = t0 + u * nwarps;
      const int s = lo + t * kTileKeys + lane;
      kp[u] = t < n_tiles && s < hi ? kv.position(s) : -1;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int t = t0 + u * nwarps;
      const unsigned m =
          __ballot_sync(ATTN_FULL_MASK, key_needed(kp[u], qmin, qmax, window));
      if (lane == 0 && t < n_tiles) mask_s[t] = m;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool keep = t < n_tiles && mask_s[t] != 0u;
      const unsigned bal = __ballot_sync(ATTN_FULL_MASK, keep);
      if (keep) list_s[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
    }
    if (lane == 0) *n_s = n;
  }
  __syncthreads();
  return *n_s;
}

// ---------------------------------------------------------------------------
// The tile ring.  kStages slots, each one 32-key tile: the keys' int32
// positions, then K and V rows at the padded pitch RingPitch.  A tile is
// filled with 16-byte cp.async.cg copies (positions with 4-byte
// cp.async.ca); a key outside the tile's ballot gets position -1 and
// zero-filled K/V rows (src-size 0: nothing is read).  Tile i + kStages -
// 1 is in flight while tile i is computed; one barrier per tile.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Tensor-core fragments: ldmatrix from shared memory (.trans for an
// operand stored k-major) and one m16n8k16 mma.sync, bf16 in, f32
// accumulate (partial_prefill.cu, grouped_mm.cu).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(const void* p, unsigned& r0,
                                        unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p, unsigned& r0,
                                              unsigned& r1, unsigned& r2,
                                              unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

// c += a b: one m16n8k16 product, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <typename T, int HD>
struct TileRing {
  static constexpr int KP = RingPitch<T, HD>::value;  // K/V row pitch
  static constexpr int kChunk = 16 / (int)sizeof(T);  // elements / copy
  static constexpr int kChunks = HD / kChunk;         // copies per row
  static constexpr int kPosBytes = kTileKeys * (int)sizeof(int);
  static constexpr int kRowsBytes = kTileKeys * KP * (int)sizeof(T);
  static constexpr int kSlotBytes = kPosBytes + 2 * kRowsBytes;
  static constexpr int kStages = 3 * kSlotBytes <= 64 * 1024 ? 3 : 2;
  static constexpr int kBytes = kStages * kSlotBytes;

  unsigned char* base;
  __device__ int* pos(int slot) const {
    return reinterpret_cast<int*>(base + slot * kSlotBytes);
  }
  __device__ T* k(int slot) const {
    return reinterpret_cast<T*>(base + slot * kSlotBytes + kPosBytes);
  }
  __device__ T* v(int slot) const { return k(slot) + kTileKeys * KP; }

  // Starts the copies of tile `t` (keys lo + 32 t ..) into `slot`; every
  // thread of the block takes its share.  `mask`: the tile's ballot.
  template <typename KV>
  __device__ void load(const KV& kv, const T* __restrict__ kg,
                       const T* __restrict__ vg, int t, unsigned mask,
                       int slot) const {
    const int s0 = kv.lo() + t * kTileKeys;
    int* ps = pos(slot);
    T* ks = k(slot);
    T* vs = v(slot);
    for (int j = threadIdx.x; j < kTileKeys; j += blockDim.x) {
      if (mask >> j & 1u)
        cp_async4(ps + j, kv.position_ptr(s0 + j));
      else
        ps[j] = -1;
    }
    for (int i = threadIdx.x; i < kTileKeys * kChunks; i += blockDim.x) {
      const int j = i / kChunks, c = i % kChunks;
      const bool fill = mask >> j & 1u;
      const size_t src = fill ? kv.row(s0 + j) * HD + c * kChunk : 0;
      cp_async16(ks + j * KP + c * kChunk, kg + src, fill);
      cp_async16(vs + j * KP + c * kChunk, vg + src, fill);
    }
  }
};

// Share `split` of `splits` of a list of n tiles: [n sp / splits, n (sp +
// 1) / splits), so shares differ by at most one tile.
__device__ __forceinline__ int2 list_share(int n, int split, int splits) {
  return make_int2(n * split / splits, n * (split + 1) / splits);
}

// ---------------------------------------------------------------------------
// Split merge (flash-decode epilogue), the counterpart of the reference's
// kernels/paged.py:102 combine_splits.  Partials of one (slot, kv head)
// group: m, l (groups, splits, R) and acc (groups, splits, R, HD), f32;
// row r of a group is query token r / g, head r % g.  One warp per row:
// the lanes own dims d = lane + 32 i, and every sum runs over the splits
// in split order, with no atomics; an empty split (NEG_INF, 0, 0) drops
// out and an all-empty row gives 0.  Output (B, C, nkv * g, HD).
// ---------------------------------------------------------------------------
constexpr int kCombineWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
    combine_splits_kernel(const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ acc, T* __restrict__ out,
                          int R, int splits, int HD, int C, int nkv, int g,
                          int n_rows) {
  const int row = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int group = row / R, r = row % R;
  const size_t base = (size_t)group * splits * R + r;
  float mg = ATTN_NEG_INF;
  for (int sp = lane; sp < splits; sp += 32)
    mg = fmaxf(mg, m[base + (size_t)sp * R]);
  mg = warp_max(mg);
  float lg = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t i = base + (size_t)sp * R;
    lg += expf(m[i] - mg) * l[i];
  }
  lg = lg == 0.f ? 1.f : lg;
  const int b = group / nkv, kvh = group % nkv, c = r / g, h = r % g;
  T* o = out + (((size_t)b * C + c) * nkv * g + kvh * g + h) * HD;
  for (int d = lane; d < HD; d += 32) {
    float a = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const size_t i = base + (size_t)sp * R;
      a += expf(m[i] - mg) * acc[i * HD + d];
    }
    o[d] = from_f32<T>(a / lg);
  }
}

template <typename T>
inline int launch_combine(const float* m, const float* l, const float* acc,
                          T* out, int groups, int R, int splits, int HD,
                          int C, int nkv, int g, cudaStream_t stream) {
  const int n_rows = groups * R;
  combine_splits_kernel<T>
      <<<(n_rows + kCombineWarps - 1) / kCombineWarps, kCombineWarps * 32, 0,
         stream>>>(m, l, acc, out, R, splits, HD, C, nkv, g, n_rows);
  return (int)cudaGetLastError();
}
