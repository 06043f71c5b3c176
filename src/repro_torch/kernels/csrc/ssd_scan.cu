// Mamba2 SSD chunked scan (state-space duality).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:75 ssd_scan
//     (body _ssd_kernel :26, pallas_call :105).
// Per (batch, head) the sequence is cut into chunks of Q = min(chunk, L)
// rows; with dAc = cumsum(dt * A) over a chunk, the chunk's output and the
// state leaving it are
//   y   = ((C B^T) o Lmat o dt_j) x + (C h^T) o exp(dAc),
//         Lmat[i, j] = exp(dAc_i - dAc_j) for j <= i, else 0
//   h  <- h exp(dAc_last) + x^T (B o w),  w = exp(dAc_last - dAc) o dt,
// starting from h0 or 0.  The reference pads L to a multiple of Q with
// dt = 0, a no-op on the state; here a chunk simply ends at row L, which
// adds the same zeros.
//
// What bounds it on the card.  Bytes and tensor-core flops would allow
// 0.019 ms at B4 L512 H80 P64 N128 (~65 MB, ~8 GFLOP of causal work).  But
// the port's plain path (models/layers.py ssd_chunked) is the oracle that
// phase 6 of chip_smoke.py holds a 64-layer model to (logit cosine >=
// 0.999), and on random weights that gate measures agreement with the
// plain path's f32 rounding, not accuracy: tensor-core versions of these
// products, with the f32 operand carried as one, two or three bf16 terms,
// gave y within half a bf16 ulp of the exact result and still failed it
// (PERF.md).  So every product here is an f32 FMA chain in the plain
// path's order -- each sum starts from zero and takes its reduction index
// in increasing order -- which makes y and h bit-identical to the plain
// path's, and bounds the kernel by the FP32 rate: ~4.1 G FMAs at that
// shape, 0.12 ms at 67 TFLOP/s (the f32 bound chip_smoke.py reports).
//
// Design: the standard SSD split into four launches, so that every chunk
// of every head works in parallel and only an elementwise pass is
// sequential over chunks.  kernels/ssd_scan.py holds each pass's plain
// PyTorch version; their composition is the specification.
//   1. ssd_prep_kernel, grid (Q / 16 row strips + H / 32 head groups,
//      chunks, batch): the strips' blocks form the chunk's C B^T once for
//      all H heads (it does not depend on the head), f32 into a (B,
//      chunks, Qp, Qp) scratch that stays in L2; the other blocks form dAc
//      for 32 heads each, a sequential f32 scan with the product rounded
//      before the add (as torch.cumsum(dt * A) runs on the card), and the
//      state weights w = exp(dAc_last - dAc) dt.
//   2. ssd_state_kernel: each chunk's own state contribution, one matrix
//      product per (batch, chunk) for all heads, which share B.
//   3. ssd_carry_kernel: walks the chunks in order, h <- h exp(dAc_last) +
//      contribution, leaving in the scratch the state that enters each
//      chunk, and writes h_final.
//   4. ssd_output_kernel, per (batch, head, 128-row tile of a chunk): the
//      inter-chunk term C h^T scaled by exp(dAc) and the intra-chunk term
//      M x with M = (C B^T) o Lmat o dt formed tile by tile from the
//      scratch (exp only where j <= i: the masked differences are positive
//      and would overflow).
// Operand tiles come in through cp.async (raw) or are converted to f32 as
// they are staged; thread tiles of 4 x 4 or 8 x 4 outputs read their
// operands as float4.  No atomics: every sum has a fixed order, so a call
// gives the same bits on every run.
#include <type_traits>

#include "attn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOutThreads = 512;        // threads of an output block
constexpr int kRowsCB = 16;             // C B^T rows of a prep block
constexpr int kTile = 64;               // chunk rows of a j tile
constexpr int kIT = 128;                // chunk rows of an output i tile
constexpr int kTP = kTile + 4;          // pitch of f32 tiles read as float4
constexpr int kScanHeads = 32;          // heads of one dAc block
constexpr int kMaxP = 64, kMaxN = 128, kMaxQ = 256;

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

// Pitch (elements) of a raw row of `width` T values in shared memory: a
// whole number of 16-byte chunks plus one
template <typename T>
__host__ __device__ inline int raw_pitch(int width) {
  constexpr int ce = 16 / (int)sizeof(T);
  return (width + ce - 1) / ce * ce + ce;
}

// four consecutive elements as f32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// Rows [0, rows) x columns [0, width) of a row-major source, transposed,
// as f32 into shared memory: dst[c * pitch + r], rows [rows, rows_pad)
// zero.  Four elements a load where the width and the row stride are
// whole numbers of fours (the source then starts on four elements, as
// every caller's does); neighbouring threads take neighbouring rows, so
// their stores fall in distinct banks.
template <typename T>
__device__ void stage_f32_t(float* __restrict__ dst, int pitch,
                            const T* __restrict__ src, size_t stride,
                            int rows, int rows_pad, int width) {
  const bool vec = width % 4 == 0 && stride % 4 == 0;
  const int wv = vec ? width / 4 : width;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows_pad * wv; i += blockDim.x) {
    const int r = i % rows_pad, c = vec ? 4 * (i / rows_pad) : i / rows_pad;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows) {
      if (vec)
        load4(src + r * stride + c, v);
      else
        v[0] = to_f32(src[r * stride + c]);
    }
    for (int e = 0; e < (vec ? 4 : 1); ++e) dst[(c + e) * pitch + r] = v[e];
  }
}

// Rows [0, rows) x columns [0, width) of a row-major T source copied raw
// into shared memory at `pitch` (a whole number of 16-byte chunks):
// 16-byte cp.async copies when a row is a whole number of 16-byte chunks,
// else element copies.
// The caller commits, waits and synchronises.
template <typename T>
__device__ void stage_raw(T* dst, int pitch, const T* __restrict__ src,
                          size_t stride, int rows, int width) {
  constexpr int ce = 16 / (int)sizeof(T);
  if (width % ce == 0) {
    const int chunks = width / ce;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i % chunks;
      cp_async16(dst + r * pitch + c * ce, src + r * stride + c * ce, true);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x)
      dst[(i / width) * pitch + i % width] = src[(i / width) * stride +
                                                 i % width];
  }
}

// Element offset of dAc[b, c, j, h] in the (B, nc, Qp, H) scratch
__device__ __forceinline__ size_t dac_at(int b, int c, int j, int h, int nc,
                                         int Qp, int H) {
  return (((size_t)b * nc + c) * Qp + j) * H + h;
}

// ---------------------------------------------------------------------------
// 1. C B^T once per (batch, chunk) (blocks x < strips, 16 rows each), and
//    dAc and w = exp(dAc_last - dAc) dt for every head (the blocks after
//    them, 32 heads each)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_prep_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    float* __restrict__ cb, float* __restrict__ dac,
                    float* __restrict__ wgt, int L, int H, int N, int Q,
                    int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int si = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c0 = c * Q, rows = min(Q, L - c0), Qp = up16(Q);
  const int strips = Qp / kRowsCB;
  const size_t row0 = (size_t)b * L + c0;

  if (si >= strips) {
    // dAc of 32 heads: dt staged in shared memory by the whole block (all
    // loads in flight at once), then one thread per head scans it
    constexpr int kHP = kScanHeads + 1;
    float* d_s = reinterpret_cast<float*>(smem_raw);   // Qp x kHP
    const int hb = (si - strips) * kScanHeads;
    for (int i = tid; i < Qp * kScanHeads; i += kThreads) {
      const int j = i / kScanHeads, hl = i % kScanHeads;
      if (j < rows && hb + hl < H)
        cp_async4(d_s + j * kHP + hl, dt + (row0 + j) * H + hb + hl);
      else
        d_s[j * kHP + hl] = 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid < kScanHeads && hb + tid < H) {
      const float a = A[hb + tid];
      float acc = 0.f;
      for (int j0 = 0; j0 < Qp; j0 += 16) {   // 16 loads in flight
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = d_s[(j0 + u) * kHP + tid];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (j0 + u < rows) acc = __fadd_rn(acc, __fmul_rn(v[u], a));
          v[u] = acc;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) d_s[(j0 + u) * kHP + tid] = v[u];
      }
    }
    __syncthreads();
    for (int i = tid; i < Qp * kScanHeads; i += kThreads) {
      const int j = i / kScanHeads, hl = i % kScanHeads, hh = hb + hl;
      if (hh >= H) continue;
      const float dj = d_s[j * kHP + hl];
      const size_t at = dac_at(b, c, j, hh, nc, Qp, H);
      dac[at] = dj;
      wgt[at] = j < rows ? expf(d_s[(rows - 1) * kHP + hl] - dj) *
                               dt[(row0 + j) * H + hh]
                         : 0.f;
    }
    return;
  }

  // CB rows [i0, i0 + 16), columns [0, J): the causal part of the strip.
  // Thread j takes column j of all 16 rows, summing over n in order from
  // zero with FMAs: the plain path's f32 order, so the scores agree bit
  // for bit where its matrix product sums the same way.  B's rows come in
  // raw, 4-byte words at an odd word pitch (each thread reads its own row
  // without bank conflicts), C's rows transposed in f32.
  constexpr int kE = 4 / (int)sizeof(T);             // elements a word
  const int i0 = si * kRowsCB, J = i0 + kRowsCB;
  const int NW = (N + kE - 1) / kE, BW = NW | 1;     // words a row, pitch
  unsigned* b_s = reinterpret_cast<unsigned*>(smem_raw);   // J x BW
  float* ct_s = reinterpret_cast<float*>(b_s + up4(Qp * BW));  // N x 16
  for (int i = tid; i < J * NW; i += kThreads) {
    const int r = i / NW, w = i % NW;
    const T* src = Bm + (row0 + r) * N + kE * w;
    if (r < rows && N % kE == 0) {
      cp_async4(b_s + r * BW + w, src);
    } else {
      alignas(4) T e2[kE];
      for (int e = 0; e < kE; ++e)
        e2[e] = r < rows && kE * w + e < N ? src[e] : from_f32<T>(0.f);
      b_s[r * BW + w] = *reinterpret_cast<const unsigned*>(e2);
    }
  }
  cp_async_commit();
  stage_f32_t(ct_s, kRowsCB, Cm + (row0 + i0) * N, N,
              max(0, min(kRowsCB, rows - i0)), kRowsCB, N);
  cp_async_wait<0>();
  __syncthreads();
  const int j = tid;
  if (j >= J) return;
  float acc[kRowsCB] = {};
  const unsigned* br = b_s + j * BW;
  for (int w = 0; w < NW; ++w) {
    const unsigned u = br[w];
    float bv[kE];
    if (kE == 2) {   // bf16 -> f32 is exact: the high half
      bv[0] = __uint_as_float(u << 16);
      bv[kE - 1] = __uint_as_float(u & 0xffff0000u);
    } else {
      bv[0] = __uint_as_float(u);
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int n = kE * w + e;
      if (n >= N) break;
#pragma unroll
      for (int r4 = 0; r4 < kRowsCB; r4 += 4) {
        const float4 cv =
            *reinterpret_cast<const float4*>(ct_s + n * kRowsCB + r4);
        acc[r4] = fmaf(cv.x, bv[e], acc[r4]);
        acc[r4 + 1] = fmaf(cv.y, bv[e], acc[r4 + 1]);
        acc[r4 + 2] = fmaf(cv.z, bv[e], acc[r4 + 2]);
        acc[r4 + 3] = fmaf(cv.w, bv[e], acc[r4 + 3]);
      }
    }
  }
  float* cbo = cb + ((size_t)b * nc + c) * Qp * Qp;
#pragma unroll
  for (int r = 0; r < kRowsCB; ++r) cbo[(size_t)(i0 + r) * Qp + j] = acc[r];
}

// ---------------------------------------------------------------------------
// 2. Each chunk's own state contribution x^T (B o w).  Within one (batch,
//    chunk) every head shares B, so the H heads' contributions are one
//    matrix product: the H P rows m = (head, p) of x o w against B, summed
//    over the chunk's rows j in order from zero with FMAs (the plain
//    path's order; x o w rounded first, as it rounds it).  Tiles of 128 m
//    x 64 n, 32 j a step; the next step's x and B are loaded into
//    registers while the current one is multiplied.  Thread (ty, tx) owns
//    m = 8 ty .. 8 ty + 7 and n = 4 tx .. 4 tx + 3 of the tile.
// ---------------------------------------------------------------------------
constexpr int kGM = 128, kGN = 64, kGK = 32;   // state product tiles
constexpr int kGMP = kGM + 4, kGNP = kGN + 4;

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ wgt,
                     const T* __restrict__ Bm, float* __restrict__ st, int L,
                     int H, int P, int N, int Q, int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a_s = reinterpret_cast<float*>(smem_raw);   // 2 x kGK x kGMP
  float* b_s = a_s + 2 * kGK * kGMP;                  // 2 x kGK x kGNP
  const int HP = H * P, n_nt = (N + kGN - 1) / kGN;
  const int m0 = blockIdx.x * kGM, n0 = blockIdx.y % n_nt * kGN;
  const int c = blockIdx.y / n_nt, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c0 = c * Q, rows = min(Q, L - c0), Qp = up16(Q);
  const size_t row0 = (size_t)b * L + c0;
  const float* wc = wgt + ((size_t)b * nc + c) * Qp * H;   // (Qp, H)
  // staging: thread t takes row k = t / 8 of a step, 16 m and 8 n of it
  const int sk = tid / 8, sm = 16 * (tid % 8), sn = 8 * (tid % 8);
  const bool a_vec = HP % 16 == 0 && m0 + sm + 16 <= HP;
  const bool a_one_head = P % 16 == 0;
  const bool b_vec = N % 8 == 0 && n0 + sn + 8 <= N;
  float ra[16], rb[8];
  auto load = [&](int j0) {
    const int j = j0 + sk;
    for (int e = 0; e < 16; ++e) ra[e] = 0.f;
    for (int e = 0; e < 8; ++e) rb[e] = 0.f;
    if (j >= rows) return;
    const T* xs = x + (row0 + j) * HP + m0 + sm;
    if (a_vec) {
      load4(xs, *reinterpret_cast<float(*)[4]>(ra));
      load4(xs + 4, *reinterpret_cast<float(*)[4]>(ra + 4));
      load4(xs + 8, *reinterpret_cast<float(*)[4]>(ra + 8));
      load4(xs + 12, *reinterpret_cast<float(*)[4]>(ra + 12));
    } else {
      for (int e = 0; e < 16; ++e)
        if (m0 + sm + e < HP) ra[e] = to_f32(xs[e]);
    }
    if (a_one_head && a_vec) {
      const float w = wc[(size_t)j * H + (m0 + sm) / P];
      for (int e = 0; e < 16; ++e) ra[e] *= w;
    } else {
      for (int e = 0; e < 16; ++e)
        if (m0 + sm + e < HP) ra[e] *= wc[(size_t)j * H + (m0 + sm + e) / P];
    }
    const T* bs = Bm + (row0 + j) * N + n0 + sn;
    if (b_vec) {
      load4(bs, *reinterpret_cast<float(*)[4]>(rb));
      load4(bs + 4, *reinterpret_cast<float(*)[4]>(rb + 4));
    } else {
      for (int e = 0; e < 8; ++e)
        if (n0 + sn + e < N) rb[e] = to_f32(bs[e]);
    }
  };
  auto store = [&](int buf) {
    float* a = a_s + (buf * kGK + sk) * kGMP + sm;
    float* bb = b_s + (buf * kGK + sk) * kGNP + sn;
#pragma unroll
    for (int e = 0; e < 16; e += 4)
      *reinterpret_cast<float4*>(a + e) =
          make_float4(ra[e], ra[e + 1], ra[e + 2], ra[e + 3]);
    *reinterpret_cast<float4*>(bb) = make_float4(rb[0], rb[1], rb[2], rb[3]);
    *reinterpret_cast<float4*>(bb + 4) =
        make_float4(rb[4], rb[5], rb[6], rb[7]);
  };
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][4] = {};
  load(0);
  store(0);
  __syncthreads();
  for (int j0 = 0, buf = 0; j0 < rows; j0 += kGK, buf ^= 1) {
    const bool more = j0 + kGK < rows;
    if (more) load(j0 + kGK);
    const int kr = min(kGK, rows - j0);
    const float* a = a_s + buf * kGK * kGMP + 8 * ty;
    const float* bb = b_s + buf * kGK * kGNP + 4 * tx;
#pragma unroll 4
    for (int k = 0; k < kr; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * kGMP);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * kGMP + 4);
      const float4 bv = *reinterpret_cast<const float4*>(bb + k * kGNP);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(av[i], bw[e], acc[i][e]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }
  float* out = st + ((size_t)b * nc + c) * HP * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 8 * ty + i;
    if (m >= HP) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 4 * tx + e;
      if (n < N) out[(size_t)m * N + n] = acc[i][e];
    }
  }
}

// ---------------------------------------------------------------------------
// 3. The state carried across chunks: one thread per V elements of (B,
//    H, P, N).  st[b, c] holds chunk c's contribution on entry and the
//    state entering chunk c on exit (c >= 1; chunk 0's is h0).
// ---------------------------------------------------------------------------
template <int V>
__global__ void __launch_bounds__(kThreads)
    ssd_carry_kernel(const float* __restrict__ h0, const float* __restrict__ dac,
                     float* __restrict__ st, float* __restrict__ h_out, int L,
                     int H, int PN, int Q, int nc, int total) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int idx = blockIdx.x * kThreads + threadIdx.x;   // V elements
  if (idx >= total) return;
  const int per = PN / V;
  const int bh = idx / per, e = idx % per;
  const int b = bh / H, h = bh % H;
  const int Qp = up16(Q);
  auto at = [&](int c) {
    return reinterpret_cast<Vec*>(st + (((size_t)b * nc + c) * H + h) * PN) +
           e;
  };
  Vec hv;
  float* hf = reinterpret_cast<float*>(&hv);
  if (h0)
    hv = reinterpret_cast<const Vec*>(h0)[idx];
  else
    for (int k = 0; k < V; ++k) hf[k] = 0.f;
  Vec nxt = *at(0);   // chunk c + 1's contribution, loaded one step ahead
  for (int c = 0; c < nc; ++c) {
    Vec cur = nxt;
    if (c + 1 < nc) nxt = *at(c + 1);
    const int rows = min(Q, L - c * Q);
    const float decay = expf(dac[dac_at(b, c, rows - 1, h, nc, Qp, H)]);
    if (c > 0) *at(c) = hv;
    const float* cf = reinterpret_cast<const float*>(&cur);
#pragma unroll
    for (int k = 0; k < V; ++k)
      hf[k] = __fadd_rn(__fmul_rn(hf[k], decay), cf[k]);
  }
  reinterpret_cast<Vec*>(h_out)[idx] = hv;
}

// ---------------------------------------------------------------------------
// 4. Each chunk's y, per (batch, head, 128-row i tile): thread (ty, tx)
//    owns rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of the tile
//    (512 threads: registers stay under 64, so two blocks of 16 warps
//    share an SM).  Yo = exp(dAc_i) (C_i . h_p), summed over n in order
//    from zero, four n at a time from the tile's C rows (copied raw with
//    cp.async as the block starts) and h^T (staged in f32); Yd = sum over
//    j <= i of M[i, j] x[j, :] in order from zero, with M = (CB o Lmat) o
//    dt_j formed one 128 x 64 tile at a time in shared memory (exp only
//    where j <= i) and read two j at a time by the FMA loop; the next
//    tile's CB block and x rows are copied raw with cp.async while the
//    FMA loop runs; y = Yd + Yo.  Every sum is the plain path's, in its
//    order.  The Yo operands and the Yd tiles share one region of shared
//    memory.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kOutThreads, 2)
    ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Cm, const float* __restrict__ h0,
                      const float* __restrict__ cb,
                      const float* __restrict__ dac,
                      const float* __restrict__ st, T* __restrict__ y, int L,
                      int H, int P, int N, int Q, int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Qp = up16(Q), n_it = (Qp + kIT - 1) / kIT;
  const int h = blockIdx.x, c = blockIdx.y / n_it, b = blockIdx.z;
  const int i0 = blockIdx.y % n_it * kIT;
  const int tid = threadIdx.x;
  const int c0 = c * Q, rows = min(Q, L - c0);
  if (i0 >= rows) return;
  const int ir = min(kIT, rows - i0);
  const size_t row0 = (size_t)b * L + c0;
  const size_t xrow = (size_t)H * P;
  const int XR = raw_pitch<T>(P);
  // the state entering the chunk: h0 (or none) for the first
  const float* hp = c > 0 ? st + (((size_t)b * nc + c) * H + h) * P * N
                    : h0  ? h0 + ((size_t)b * H + h) * P * N
                          : nullptr;
  const float* cbc = cb + ((size_t)b * nc + c) * Qp * Qp;
  float* dac_s = reinterpret_cast<float*>(smem_raw);   // Qp
  float* dt_s = dac_s + Qp;                            // Qp
  T* xr_s = reinterpret_cast<T*>(dt_s + Qp);           // 2 x kTile x XR
  float* u_s = reinterpret_cast<float*>(xr_s + 2 * kTile * XR);
  const int CR = raw_pitch<T>(N);
  float* ht_s = u_s;                                   // N x kTP: h^T
  T* cr_s = reinterpret_cast<T*>(ht_s + up4(N) * kTP);  // kIT x CR: C rows
  float* m_s = u_s;                                    // kIT x kTP: M
  float* cbr_s = m_s + kIT * kTP;                      // kIT x kTP: CB
  const int jend = min(rows, i0 + kIT);                // j this tile needs
  auto fetch_x = [&](int j0, int buf) {
    if (j0 < jend)
      stage_raw(xr_s + buf * kTile * XR, XR,
                x + (row0 + j0) * xrow + (size_t)h * P, xrow,
                min(kTile, rows - j0), P);
  };
  // CB rows i0 .. i0 + ir - 1, columns j0 .. j0 + 63 (entries past the
  // diagonal are copied but never used)
  auto fetch_cb = [&](int j0) {
    if (j0 < jend)
      stage_raw(cbr_s, kTP, cbc + (size_t)i0 * Qp + j0, Qp, ir, kTile);
  };
  if (hp) stage_raw(cr_s, CR, Cm + (row0 + i0) * N, N, ir, N);
  cp_async_commit();
  fetch_x(0, 0);   // x tile 0 streams in under the inter-chunk term
  cp_async_commit();
  if (hp) stage_f32_t(ht_s, kTP, hp, N, P, P, N);
  for (int j = tid; j < Qp; j += kOutThreads) {
    dac_s[j] = dac[dac_at(b, c, j, h, nc, Qp, H)];
    dt_s[j] = j < rows ? dt[(row0 + j) * H + h] : 0.f;
  }
  constexpr int kR = kIT * 16 / kOutThreads;   // rows a thread owns (4)
  const int ty = tid / 16, tx = tid % 16;
  const bool own = 4 * tx < P;
  float yo[kR][4] = {};
  cp_async_wait<1>();
  __syncthreads();   // dAc, dt and the Yo operands in place
  if (hp && own) {
    // rows past the tile's end are never read; a thread's rows past ir
    // and columns past P read padding and are not stored
    const T* cr = cr_s + kR * ty * CR;
    const float* ht = ht_s + 4 * tx;
    const int nv = N % 4 == 0 ? N : 0;   // four n at a time where possible
    int n = 0;
    for (; n < nv; n += 4) {
      float ha[4][4];   // ha[k][e] = h[4 tx + e][n + k]
#pragma unroll
      for (int k = 0; k < 4; ++k) load4(ht + (n + k) * kTP, ha[k]);
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        if (kR * ty + a >= ir) break;
        float ca[4];
        load4(cr + a * CR + n, ca);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            yo[a][e] = fmaf(ca[k], ha[k][e], yo[a][e]);
      }
    }
    for (; n < N; ++n)
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        if (kR * ty + a >= ir) break;
        const float cv = to_f32(cr[a * CR + n]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          yo[a][e] = fmaf(cv, ht[n * kTP + e], yo[a][e]);
      }
  }
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = i0 + kR * ty + a;
    const float ea = i < rows ? expf(dac_s[i]) : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) yo[a][e] *= ea;
  }
  __syncthreads();   // the Yo operands are read: M and CB take their place
  fetch_cb(0);
  cp_async_commit();

  constexpr int kME = kIT * kTile / kOutThreads;   // M entries a thread
  constexpr int kIS = kOutThreads / kTile;   // row stride of those entries
  const int jl = tid % kTile, il0 = tid / kTile;
  float acc[kR][4] = {};
  for (int j0 = 0, t = 0; j0 < jend; j0 += kTile, ++t) {
    const int jr = min(kTile, rows - j0), buf = t & 1;
    cp_async_wait<0>();
    __syncthreads();   // CB and x tile t landed; M and x tile t - 1 read
    // M[i][j] = (CB o Lmat) o dt_j: column jl of rows il0 + kIS k
    const int j = j0 + jl;
    const float daj = dac_s[j], dtj = dt_s[j];
#pragma unroll 4
    for (int k = 0; k < kME; ++k) {
      const int il = il0 + kIS * k, i = i0 + il;
      m_s[il * kTP + jl] = j <= i && i < rows
                               ? cbr_s[il * kTP + jl] * expf(dac_s[i] - daj) *
                                     dtj
                               : 0.f;
    }
    __syncthreads();   // M in place; the CB block is free
    fetch_cb(j0 + kTile);
    fetch_x(j0 + kTile, buf ^ 1);
    cp_async_commit();
    if (!own) continue;
    const T* xr = xr_s + buf * kTile * XR + 4 * tx;
    // j up to this thread's last row (later j would add M = 0), two at a
    // time; each accumulator still takes j in order
    const int jmax = min(jr, i0 + kR * ty + kR - j0);
    const float* mr = m_s + kR * ty * kTP;
    int jj = 0;
    for (; jj + 1 < jmax; jj += 2) {
      float2 m2[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a)
        m2[a] = *reinterpret_cast<const float2*>(mr + a * kTP + jj);
      float xa[4], xb[4];
      load4(xr + jj * XR, xa);
      load4(xr + (jj + 1) * XR, xb);
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[a][e] = fmaf(m2[a].x, xa[e], acc[a][e]);
          acc[a][e] = fmaf(m2[a].y, xb[e], acc[a][e]);
        }
    }
    if (jj < jmax) {
      float xa[4];
      load4(xr + jj * XR, xa);
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        const float mv = mr[a * kTP + jj];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(mv, xa[e], acc[a][e]);
      }
    }
  }
  cp_async_wait<0>();
  if (!own) return;
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = i0 + kR * ty + a;
    if (i >= rows) continue;
    T* yr = y + (row0 + i) * xrow + (size_t)h * P + 4 * tx;
    alignas(16) T v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = from_f32<T>(acc[a][e] + yo[a][e]);
    if (P % 4 == 0) {   // four columns in one store
      if (sizeof(T) == 2)
        *reinterpret_cast<uint2*>(yr) = *reinterpret_cast<const uint2*>(v);
      else
        *reinterpret_cast<uint4*>(yr) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int e = 0; e < 4; ++e)
        if (4 * tx + e < P) yr[e] = v[e];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* h_out, void* cb,
           void* dac, void* wgt, void* st, int B, int L, int H, int P, int N,
           int Q, cudaStream_t stream) {
  const int nc = (L + Q - 1) / Q, Qp = up16(Q);
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* h0f = static_cast<const float*>(h0);
  float* cbf = static_cast<float*>(cb);
  float* dacf = static_cast<float*>(dac);
  float* stf = static_cast<float*>(st);
  cudaError_t err;

  const int strips = Qp / kRowsCB;
  const int scan_blocks = (H + kScanHeads - 1) / kScanHeads;
  const int BW = ((N + 4 / (int)sizeof(T) - 1) / (4 / (int)sizeof(T))) | 1;
  const size_t prep_smem =
      sizeof(float) * max(Qp * (kScanHeads + 1), up4(Qp * BW) + N * kRowsCB);
  auto prep = ssd_prep_kernel<T>;
  if ((err = attn_set_smem(prep, prep_smem)) != cudaSuccess) return (int)err;
  prep<<<dim3(strips + scan_blocks, nc, B), kThreads, prep_smem, stream>>>(
      dtf, static_cast<const float*>(A), Bt, Ct, cbf, dacf,
      static_cast<float*>(wgt), L, H, N, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t state_smem = sizeof(float) * 2 * kGK * (kGMP + kGNP);
  auto state = ssd_state_kernel<T>;
  if ((err = attn_set_smem(state, state_smem)) != cudaSuccess) return (int)err;
  state<<<dim3((H * P + kGM - 1) / kGM, (N + kGN - 1) / kGN * nc, B),
          kThreads, state_smem, stream>>>(
      xt, static_cast<const float*>(wgt), Bt, stf, L, H, P, N, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // four state elements a thread where a row of the state allows it
  const int PN = P * N, V = PN % 4 == 0 ? 4 : 1;
  const int total = B * H * (PN / V);
  const unsigned carry_blocks = (total + kThreads - 1) / kThreads;
  if (V == 4)
    ssd_carry_kernel<4><<<carry_blocks, kThreads, 0, stream>>>(
        h0f, dacf, stf, static_cast<float*>(h_out), L, H, PN, Q, nc, total);
  else
    ssd_carry_kernel<1><<<carry_blocks, kThreads, 0, stream>>>(
        h0f, dacf, stf, static_cast<float*>(h_out), L, H, PN, Q, nc, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t out_smem =
      max(sizeof(float) * up4(N) * kTP + sizeof(T) * kIT * raw_pitch<T>(N),
          sizeof(float) * 2 * kIT * kTP) +
      sizeof(float) * 2 * Qp +
      sizeof(T) * 2 * kTile * raw_pitch<T>(P);
  auto output = ssd_output_kernel<T>;
  if ((err = attn_set_smem(output, out_smem)) != cudaSuccess) return (int)err;
  output<<<dim3(H, nc * ((Qp + kIT - 1) / kIT), B), kOutThreads, out_smem,
           stream>>>(
      xt, dtf, Ct, h0f, cbf, dacf, stf, static_cast<T*>(y), L, H, P, N, Q,
      nc);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L, H, P) and y; dt (B, L, H) f32, softplus'd; A (H,) f32; Bm, Cm
// (B, L, N) in x's type; h0 (B, H, P, N) f32 or null (zero state); h_out
// (B, H, P, N) f32.  Q = min(chunk, L); with nc = ceil(L / Q) chunks and
// Qp = Q rounded up to 16, f32 scratch: cb (B, nc, Qp, Qp), dac and wgt
// (B, nc, Qp, H), st (B, nc, H, P, N).  All contiguous, on one device,
// 16-byte aligned.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* h0, void* y, void* h_out, void* cb,
                               void* dac, void* wgt, void* st, int B, int L,
                               int H, int P, int N, int Q, int dtype,
                               void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || Q <= 0 || Q > kMaxQ || !cb || !dac || !wgt || !st)
    return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH_DTYPE(dtype, return launch<T>(x, dt, A, Bm, Cm, h0, y, h_out,
                                              cb, dac, wgt, st, B, L, H, P, N,
                                              Q,
                                              static_cast<cudaStream_t>(
                                                  stream)));
  return (int)cudaErrorInvalidValue;
}
