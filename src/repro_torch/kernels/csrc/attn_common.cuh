// Shared helpers for the hand-written Hopper attention kernels.
//
// Every kernel is templated over the element type (float or
// __nv_bfloat16) and the head dim (16, 32, 64 or 128); all arithmetic
// runs in f32.  The masking constant and the l == 0 -> 1 guard follow
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
// __syncthreads(); position(s) is -1 for a key that must not be read.
// ---------------------------------------------------------------------------

// Dense cache: k, v (B, S, nkv, hd); positions (B, S).
struct DenseKV {
  const int* pos;
  int S, nkv;
  int b_, kvh_;

  static int table_ints(int /*split_entries*/) { return 0; }
  __device__ void bind(int b, int kvh, int /*split*/, int* /*tbl_s*/) {
    b_ = b;
    kvh_ = kvh;
  }
  __device__ int lo() const { return 0; }
  __device__ int hi() const { return S; }
  __device__ int position(int s) const { return pos[(size_t)b_ * S + s]; }
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
  __device__ int position(int s) const {
    const int blk = block(s);
    return blk < 0 ? -1 : pos[(size_t)blk * bs + s % bs];
  }
  __device__ size_t row(int s) const {
    return ((size_t)block(s) * bs + s % bs) * nkv + kvh_;
  }
};

// ---------------------------------------------------------------------------
// Split merge (flash-decode epilogue), the counterpart of the reference's
// kernels/paged.py:102 combine_splits.  Partials of one (slot, kv head)
// group: m, l (groups, splits, R) and acc (groups, splits, R, HD), f32;
// row r of a group is query token r / g, head r % g.  Merged in split
// order with no atomics; an empty split (NEG_INF, 0, 0) drops out and an
// all-empty row gives 0.  Output (B, C, nkv * g, HD).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void combine_splits_kernel(const float* __restrict__ m,
                                      const float* __restrict__ l,
                                      const float* __restrict__ acc,
                                      T* __restrict__ out, int R, int splits,
                                      int HD, int C, int nkv, int g) {
  const int group = blockIdx.x, r = blockIdx.y;
  const size_t base = (size_t)group * splits * R + r;
  float mg = ATTN_NEG_INF;
  for (int sp = 0; sp < splits; ++sp) mg = fmaxf(mg, m[base + (size_t)sp * R]);
  float lg = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t i = base + (size_t)sp * R;
    lg += expf(m[i] - mg) * l[i];
  }
  lg = lg == 0.f ? 1.f : lg;
  const int b = group / nkv, kvh = group % nkv, c = r / g, h = r % g;
  T* o = out + (((size_t)b * C + c) * nkv * g + kvh * g + h) * HD;
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
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
  combine_splits_kernel<T><<<dim3(groups, R), 128, 0, stream>>>(
      m, l, acc, out, R, splits, HD, C, nkv, g);
  return (int)cudaGetLastError();
}
