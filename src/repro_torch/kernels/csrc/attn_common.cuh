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
