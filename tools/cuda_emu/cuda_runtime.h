// CPU stand-in for <cuda_runtime.h>, for tools/cuda_emu/emulate.py: one
// std::thread per CUDA thread, a std::barrier for __syncthreads() and a
// per-warp barrier plus exchange buffer for the warp collectives,
// ldmatrix and mma.sync; mbarriers and named barriers (bar.sync) for the
// TMA kernels (cuda.h beside this file holds the TMA and wgmma stand-ins).
// cp.async and TMA are synchronous copies (a missing wait does not show).
// For logic checks only: nothing here is timed.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define CUDART_VERSION 12080

struct uint3 { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct int2 { int x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline int2 make_int2(int a, int b) { return {a, b}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}

inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
template <class V>
V __ldg(const V* p) { return *p; }
// one tick per 100 ns: a wait bound of 2e10 cycles (~10 s on the card)
// is ~2,000 s here, where 288 threads share a few cores
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
             .count() /
         100;
}
inline void __trap() { std::abort(); }

namespace emu {
struct Mbar {  // an mbarrier: arrivals and TMA bytes still due, phase
  int count = 0, pending = 0, phase = 0;
  long long tx = 0;
};
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<uint64_t> xch;              // 8 words per lane
  std::vector<unsigned char> smem;
  std::mutex mu;                          // guards mbars and nbars
  std::map<uint32_t, Mbar> mbars;         // by shared address
  std::map<int, std::unique_ptr<std::barrier<>>> nbars;  // bar.sync ids
};
inline thread_local Block* cur = nullptr;
inline unsigned char* smem() { return cur->smem.data(); }
inline int warp_id() { return threadIdx.x / 32; }
inline int lane_id() { return threadIdx.x % 32; }
inline uint64_t* xch(int lane, int slot) {
  return &cur->xch[((size_t)warp_id() * 32 + lane) * 8 + slot];
}
inline void wsync() { cur->wbar[warp_id()]->arrive_and_wait(); }

// Runs the grid block by block; shared memory is filled with NaN bytes
// and sized exactly, so uninitialised reads and overflows show.
template <class K, class... Args>
void launch(K kernel, dim3 grid, dim3 block, size_t smem_bytes, cudaStream_t,
            Args... args) {
  const unsigned nt = block.x;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        Block blk;
        blk.bar = std::make_unique<std::barrier<>>(nt);
        for (unsigned w = 0; w < (nt + 31) / 32; ++w)
          blk.wbar.push_back(
              std::make_unique<std::barrier<>>(std::min(32u, nt - 32 * w)));
        blk.xch.assign((size_t)(nt + 31) / 32 * 32 * 8, 0);
        blk.smem.assign(smem_bytes, 0xff);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            cur = &blk;
            threadIdx = uint3{t, 0, 0};
            blockIdx = uint3{bx, by, bz};
            blockDim = block;
            gridDim = grid;
            kernel(args...);
            blk.wbar[t / 32]->arrive_and_drop();
            blk.bar->arrive_and_drop();
          });
        for (auto& th : ts) th.join();
      }
}

// ldmatrix.x4: lane l gives the address of row l % 8 of matrix l / 8
inline void ldsm(const void* p, unsigned& r0, unsigned& r1, unsigned& r2,
                 unsigned& r3, bool trans) {
  const int L = lane_id();
  *xch(L, 0) = (uint64_t)(uintptr_t)p;
  wsync();
  unsigned r[4];
  for (int m = 0; m < 4; ++m) {
    uint16_t e[2];
    for (int k = 0; k < 2; ++k) {
      const int src = trans ? 8 * m + 2 * (L % 4) + k : 8 * m + L / 4;
      const uint16_t* row = (const uint16_t*)(uintptr_t)*xch(src, 0);
      e[k] = row[trans ? L / 4 : 2 * (L % 4) + k];
    }
    r[m] = (unsigned)e[0] | ((unsigned)e[1] << 16);
  }
  wsync();
  r0 = r[0];
  r1 = r[1];
  r2 = r[2];
  r3 = r[3];
}

inline float bf_half(unsigned v, int hi) {
  return __uint_as_float(hi ? (v & 0xffff0000u) : (v << 16));
}

// mma.sync.m16n8k16 bf16 -> f32, fragments gathered across the warp
inline void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                unsigned b1) {
  const int L = lane_id();
  for (int i = 0; i < 4; ++i) *xch(L, i) = a[i];
  *xch(L, 4) = b0;
  *xch(L, 5) = b1;
  wsync();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, q = l % 4;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * q + h] = bf_half((unsigned)*xch(l, 0), h);
      A[g + 8][2 * q + h] = bf_half((unsigned)*xch(l, 1), h);
      A[g][2 * q + 8 + h] = bf_half((unsigned)*xch(l, 2), h);
      A[g + 8][2 * q + 8 + h] = bf_half((unsigned)*xch(l, 3), h);
      B[2 * q + h][g] = bf_half((unsigned)*xch(l, 4), h);
      B[2 * q + 8 + h][g] = bf_half((unsigned)*xch(l, 5), h);
    }
  }
  wsync();
  const int g = L / 4, q = L % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * q + (e & 1);
    float s = c[e];
    for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
    c[e] = s;
  }
}
}  // namespace emu

namespace emu {
// mbarrier phases: a phase ends when every arrival and every expected
// TMA byte has come; try_wait(parity) is true once the phase of that
// parity has ended (the current phase's parity differs)
inline void mbar_done(Mbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.count;
  }
}
inline void mbar_init(uint32_t a, int count) {
  std::lock_guard<std::mutex> g(cur->mu);
  Mbar& b = cur->mbars[a];
  b.count = b.pending = count;
  b.phase = 0;
  b.tx = 0;
}
inline void mbar_arrive(uint32_t a, long long tx) {
  std::lock_guard<std::mutex> g(cur->mu);
  Mbar& b = cur->mbars.at(a);
  b.tx += tx;
  --b.pending;
  mbar_done(b);
}
inline void mbar_complete_tx(uint32_t a, long long bytes) {
  std::lock_guard<std::mutex> g(cur->mu);
  Mbar& b = cur->mbars.at(a);
  b.tx -= bytes;
  mbar_done(b);
}
inline bool mbar_try_wait(uint32_t a, uint32_t parity) {
  static thread_local long polls = 0;
  bool done;
  {
    std::lock_guard<std::mutex> g(cur->mu);
    const Mbar& b = cur->mbars.at(a);
    done = (uint32_t)b.phase != parity;
    if (done) {
      polls = 0;
    } else if (++polls == 100000) {  // ~2 s: say who waits on what
      std::fprintf(stderr,
                   "emu: block %u thread %u waits on mbarrier @%u parity %u "
                   "(phase %d, arrivals due %d, bytes due %lld)\n",
                   blockIdx.x, threadIdx.x, a, parity, b.phase, b.pending,
                   b.tx);
    }
  }
  // a waiter sleeps rather than spins: 288 threads share a few cores
  if (!done) std::this_thread::sleep_for(std::chrono::microseconds(20));
  return done;
}
inline void named_bar(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(cur->mu);
    auto& p = cur->nbars[id];
    if (!p) p = std::make_unique<std::barrier<>>(count);
    b = p.get();
  }
  b->arrive_and_wait();
}
}  // namespace emu

inline void __syncthreads() { emu::cur->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::wsync(); }
template <class V>
V __shfl_sync_from(V v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(V));
  *emu::xch(emu::lane_id(), 0) = u;
  emu::wsync();
  const uint64_t r = *emu::xch(src, 0);
  emu::wsync();
  V out;
  std::memcpy(&out, &r, sizeof(V));
  return out;
}
template <class V>
V __shfl_up_sync(unsigned, V v, int d) {
  const V from = __shfl_sync_from(v, std::max(emu::lane_id() - d, 0));
  return emu::lane_id() >= d ? from : v;
}
template <class V>
V __shfl_xor_sync(unsigned, V v, int o) {
  return __shfl_sync_from(v, emu::lane_id() ^ o);
}
template <class V>
V __shfl_sync(unsigned, V v, int src) {
  return __shfl_sync_from(v, src);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  *emu::xch(emu::lane_id(), 0) = p;
  emu::wsync();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (unsigned)(*emu::xch(l, 0) != 0) << l;
  emu::wsync();
  return m;
}
