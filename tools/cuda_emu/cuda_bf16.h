// CPU stand-in for <cuda_bf16.h>, for tools/cuda_emu/emulate.py: the
// bf16 types and conversions the port's kernels use (round to nearest
// even, as the card rounds).
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)   // NaN stays NaN
    return __nv_bfloat16{(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float __low2float(__nv_bfloat162 h) { return __bfloat162float(h.x); }
inline float __high2float(__nv_bfloat162 h) { return __bfloat162float(h.y); }
