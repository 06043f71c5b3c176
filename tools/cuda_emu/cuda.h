// CPU stand-in for <cuda.h>, for tools/cuda_emu/emulate.py: the tensor
// map type and its encoder (reached through cudaGetDriverEntryPoint*, as
// on the card), TMA loads and stores as synchronous copies that apply
// the 128-byte swizzle and fill zeros outside the tensor, and wgmma as a
// product each thread computes for its own accumulator fragments, read
// from shared memory through the descriptors.  Shared addresses are
// offsets into the block's shared-memory buffer.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0 };
typedef int CUtensorMapDataType;
typedef int CUtensorMapInterleave;
typedef int CUtensorMapSwizzle;
typedef int CUtensorMapL2promotion;
typedef int CUtensorMapFloatOOBfill;
enum { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum { CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

struct alignas(64) CUtensorMap {
  unsigned char* base;
  int rank, swizzle;
  uint64_t dims[5], strides[5];  // strides in bytes; strides[0] = 2
  uint32_t box[5];
};

typedef int cudaDriverEntryPointQueryResult;
enum { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };

namespace emu {
inline CUresult encode_tiled(CUtensorMap* m, CUtensorMapDataType, cuuint32_t rank,
                             void* base, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box,
                             const cuuint32_t*, CUtensorMapInterleave,
                             CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill) {
  if (rank < 1 || rank > 5 || (uintptr_t)base % 16) return 1;
  m->base = static_cast<unsigned char*>(base);
  m->rank = (int)rank;
  m->swizzle = swizzle;
  m->strides[0] = sizeof(__nv_bfloat16);
  for (cuuint32_t i = 0; i < rank; ++i) {
    if (dims[i] == 0 || box[i] == 0 || box[i] > 256) return 1;
    m->dims[i] = dims[i];
    m->box[i] = box[i];
    if (i) {
      if (strides[i - 1] % 16) return 1;
      m->strides[i] = strides[i - 1];
    }
  }
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * 2 > 128) return 1;
  return CUDA_SUCCESS;
}

// the 128-byte swizzle of a shared offset: 16-byte chunk ^= row % 8
inline uint32_t swz(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

// for each element of the box at coords c: its shared offset and its
// global address (null outside the tensor)
template <class F>
void tma_box(const CUtensorMap* m, uint32_t smem, const int* c, F f) {
  const uint32_t b0 = m->box[0], b1 = m->rank > 1 ? m->box[1] : 1,
                 b2 = m->rank > 2 ? m->box[2] : 1;
  for (uint32_t i2 = 0; i2 < b2; ++i2)
    for (uint32_t i1 = 0; i1 < b1; ++i1)
      for (uint32_t i0 = 0; i0 < b0; ++i0) {
        const long long g[3] = {(long long)c[0] + i0, (long long)c[1] + i1,
                                (long long)c[2] + i2};
        const uint32_t idx[3] = {i0, i1, i2};
        bool in = true;
        size_t off = 0;
        for (int d = 0; d < m->rank; ++d) {
          in &= g[d] >= 0 && g[d] < (long long)m->dims[d];
          off += (size_t)g[d] * m->strides[d];
          (void)idx;
        }
        uint32_t s = smem + 2 * ((i2 * b1 + i1) * b0 + i0);
        if (m->swizzle == CU_TENSOR_MAP_SWIZZLE_128B) s = swz(s);
        f(s, in ? m->base + off : nullptr);
      }
}

inline void tma_load(uint32_t dst, const CUtensorMap* m, uint32_t bar,
                     const int* c) {
  long long bytes = 0;
  tma_box(m, dst, c, [&](uint32_t s, const unsigned char* g) {
    if (g)
      std::memcpy(smem() + s, g, 2);
    else
      std::memset(smem() + s, 0, 2);
    bytes += 2;
  });
  mbar_complete_tx(bar, bytes);
}

inline void tma_store(const CUtensorMap* m, uint32_t src, const int* c) {
  tma_box(m, src, c, [&](uint32_t s, const unsigned char* g) {
    if (g) std::memcpy(const_cast<unsigned char*>(g), smem() + s, 2);
  });
}

// element (mn, k) of a wgmma operand through a 128-byte-swizzle
// descriptor; K-major: rows of k, 8-row groups sbo apart; MN-major: rows
// of mn (64 a block, blocks lbo apart), one per k, 8-k groups sbo apart
inline float operand(uint64_t desc, int mn, int k, int mn_major) {
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  if ((desc >> 62) != 1) std::abort();  // only the 128-byte swizzle
  const uint32_t off =
      mn_major ? start + 2 * (mn % 64) + (mn / 64) * lbo + 128 * (k % 8) +
                     (k / 8) * sbo
               : start + 128 * (mn % 8) + (mn / 8) * sbo + 2 * k;
  __nv_bfloat16 v;
  std::memcpy(&v, smem() + swz(off), 2);
  return __bfloat162float(v);
}

// d (this thread's fragments of the 64 x n product) += A B, k = 16
inline void wgmma(float* d, int n, uint64_t da, uint64_t db, int ta,
                  int tb) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  for (int i = 0; i < n / 2; ++i) {
    const int m = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    float s = 0.f;
    for (int k = 0; k < 16; ++k)
      s += operand(da, m, k, ta) * operand(db, c, k, tb);
    d[i] += s;
  }
}
}  // namespace emu

inline cudaError_t cudaGetDriverEntryPointByVersion(
    const char*, void** fn, unsigned, unsigned long long,
    cudaDriverEntryPointQueryResult* q) {
  *fn = reinterpret_cast<void*>(&emu::encode_tiled);
  if (q) *q = cudaDriverEntryPointSuccess;
  return 0;
}
