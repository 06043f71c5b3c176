// Mamba2 SSD chunked scan (state-space duality).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:75 ssd_scan
//     (body _ssd_kernel :26, pallas_call :105).
// For each (batch, head) it walks the chunks of Q = min(chunk, L) rows in
// order with an f32 (P, N) state h, set to h0 or 0.  Per chunk:
//   dAc = cumsum(dt * A)
//   y   = ((C B^T) o Lmat o dt_j) x + (C h^T) o exp(dAc),
//         Lmat[i, j] = exp(dAc_i - dAc_j) for j <= i, else 0
//   h  <- h exp(dAc_last) + x^T (B o exp(dAc_last - dAc) o dt).
// The reference pads L to a multiple of Q with dt = 0, a no-op on the
// state; here a chunk simply ends at row L, which adds the same zeros.
//
// What bounds it on the card: bytes in bf16 (x and y dominate: at B4 L512
// H80 P64 N128 ~64 MB move against ~8 GFLOP of causal work, 0.019 ms at
// 3.35 TB/s vs 0.008 ms at 989 TFLOP/s), operations in f32 (no tensor
// cores: 67 TFLOP/s).  This first kernel is neither: it does all of its
// arithmetic as f32 FMAs from shared memory, no tensor cores, and
// recomputes C B^T for every head although the scores are shared by all
// H heads of a batch row.  Its time is in PERF.md.
//
// Design: one block of 256 threads per (batch, head), B * H blocks (80 on
// 132 SMs at batch 1: the redesign should split heads or chunks further).
// A whole chunk does not fit in shared memory at full width (a Q x Q f32
// tile alone is 256 KB), so the chunk is cut into 64-row tiles: for each
// row tile i the C rows are staged, the inter-chunk term C h^T is formed
// against the state kept in shared memory, then every column tile j <= i
// stages its B and x rows, forms the 64 x 64 tile M = (C B^T) o Lmat o dt
// in shared memory and adds M x to the y tile held in registers (a 4 x 4
// patch per thread, f32).  exp(dAc_i - dAc_j) is evaluated only where
// j <= i: the masked differences are positive and would overflow.  Every
// row of the chunk reads the state entering it, so the state update is
// accumulated in registers while the last row tile walks all column tiles
// (which then hold every B and x row of the chunk) and applied only after
// the chunk's y is written.  x and y are read and written in place in the
// (B, L, H, P) layout; Bm and Cm are one group, read by all heads.  Shared
// rows of C, B and the state have an odd pitch (N + 1), so lanes reading
// one column of consecutive rows hit distinct banks.
#include "attn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // chunk rows per tile (i and j)
constexpr int kMP = kTile + 1;          // row pitch of the M tile
constexpr int kMaxP = 64, kMaxN = 128, kMaxQ = 256;

// dst[r * pitch + c] = src[r * stride + c] as f32 for r < rows, else 0;
// r < kTile, c < width.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          size_t stride, int rows,
                                          int width) {
  for (int idx = threadIdx.x; idx < kTile * width; idx += kThreads) {
    const int r = idx / width, c = idx % width;
    dst[r * pitch + c] = r < rows ? to_f32(src[r * stride + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ h0,
                    T* __restrict__ y, float* __restrict__ h_out, int L,
                    int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;                   // row pitch of C, B and the state
  float* s_h = smem;                      // (P, NP) state entering the chunk
  float* s_c = s_h + P * NP;              // (kTile, NP) C rows of tile i
  float* s_b = s_c + kTile * NP;          // (kTile, NP) B rows of tile j
  float* s_x = s_b + kTile * NP;          // (kTile, P) x rows of tile j
  float* s_m = s_x + kTile * P;           // (kTile, kMP) M tile
  float* s_dt = s_m + kTile * kMP;        // (kMaxQ) dt of the chunk
  float* s_dac = s_dt + kMaxQ;            // (kMaxQ) cumsum(dt * A)
  float* s_w = s_dac + kMaxQ;             // (kMaxQ) exp(dAc_last - dAc) dt

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  // y and M tiles: rows ty + 16 k, columns tx + 16 k (4 x 4 per thread)
  const int ty = tid >> 4, tx = tid & 15;
  // state update: p = warp + 8 k (8 per thread), n = lane + 32 k (4)
  const int warp = tid >> 5, lane = tid & 31;
  const float a = A[h];
  const size_t bh = (size_t)b * H + h;
  const size_t xrow = (size_t)H * P;      // x / y row stride (elements)

  for (int i = tid; i < P * N; i += kThreads)
    s_h[(i / N) * NP + i % N] = h0 ? h0[bh * P * N + i] : 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int rows = min(Q, L - c0);      // rows past L would add zeros
    const size_t r0 = (size_t)b * L + c0; // first (batch, time) row
    for (int j = tid; j < kMaxQ; j += kThreads)
      s_dt[j] = j < rows ? dt[(r0 + j) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      // a sequential f32 scan with the product rounded before the add
      // (no FMA contraction), as torch.cumsum(dt * A) runs on the card
      float acc = 0.f;
      for (int j = 0; j < rows; ++j) {
        acc = __fadd_rn(acc, __fmul_rn(s_dt[j], a));
        s_dac[j] = acc;
      }
    }
    __syncthreads();
    const float dac_last = s_dac[rows - 1];
    for (int j = tid; j < kMaxQ; j += kThreads)
      s_w[j] = j < rows ? expf(dac_last - s_dac[j]) * s_dt[j] : 0.f;

    const int n_tiles = (rows + kTile - 1) / kTile;
    float upd[8][4] = {};
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      load_rows(s_c, NP, Cm + (r0 + i0) * N, N, min(kTile, rows - i0), N);
      __syncthreads();

      // inter-chunk term: y[i, p] = exp(dAc_i) * (C_i . h[p])
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          cv[k] = s_c[(ty + 16 * k) * NP + n];
          hv[k] = s_h[min(tx + 16 * k, P - 1) * NP + n];
        }
#pragma unroll
        for (int ki = 0; ki < 4; ++ki)
#pragma unroll
          for (int kp = 0; kp < 4; ++kp)
            acc[ki][kp] = fmaf(cv[ki], hv[kp], acc[ki][kp]);
      }
#pragma unroll
      for (int ki = 0; ki < 4; ++ki) {
        const int i = i0 + ty + 16 * ki;
        const float e = i < rows ? expf(s_dac[i]) : 0.f;
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) acc[ki][kp] *= e;
      }

      // intra-chunk term over column tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        const int j_rows = min(kTile, rows - j0);
        __syncthreads();                  // the last tile's s_b/s_x/s_m read
        load_rows(s_b, NP, Bm + (r0 + j0) * N, N, j_rows, N);
        load_rows(s_x, P, x + (r0 + j0) * xrow + (size_t)h * P, xrow, j_rows,
                  P);
        __syncthreads();
        float s[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            cv[k] = s_c[(ty + 16 * k) * NP + n];
            bv[k] = s_b[(tx + 16 * k) * NP + n];
          }
#pragma unroll
          for (int ki = 0; ki < 4; ++ki)
#pragma unroll
            for (int kj = 0; kj < 4; ++kj)
              s[ki][kj] = fmaf(cv[ki], bv[kj], s[ki][kj]);
        }
#pragma unroll
        for (int ki = 0; ki < 4; ++ki)
#pragma unroll
          for (int kj = 0; kj < 4; ++kj) {
            const int i = i0 + ty + 16 * ki, j = j0 + tx + 16 * kj;
            float m = 0.f;
            if (j <= i && i < rows)       // mask before the exp
              m = s[ki][kj] * expf(s_dac[i] - s_dac[j]) * s_dt[j];
            s_m[(ty + 16 * ki) * kMP + tx + 16 * kj] = m;
          }
        __syncthreads();
        for (int j = 0; j < j_rows; ++j) {
          float mv[4], xv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            mv[k] = s_m[(ty + 16 * k) * kMP + j];
            xv[k] = s_x[j * P + min(tx + 16 * k, P - 1)];
          }
#pragma unroll
          for (int ki = 0; ki < 4; ++ki)
#pragma unroll
            for (int kp = 0; kp < 4; ++kp)
              acc[ki][kp] = fmaf(mv[ki], xv[kp], acc[ki][kp]);
        }
        if (it == n_tiles - 1) {
          // the last row tile visits every column tile once: accumulate
          // the state update x^T (B o w) from the staged B and x rows
          for (int j = 0; j < j_rows; ++j) {
            const float w = s_w[j0 + j];
            float bw[4];
#pragma unroll
            for (int kn = 0; kn < 4; ++kn)
              bw[kn] = s_b[j * NP + min(lane + 32 * kn, N - 1)] * w;
#pragma unroll
            for (int kp = 0; kp < 8; ++kp) {
              const float xv = s_x[j * P + min(warp + 8 * kp, P - 1)];
#pragma unroll
              for (int kn = 0; kn < 4; ++kn)
                upd[kp][kn] = fmaf(xv, bw[kn], upd[kp][kn]);
            }
          }
        }
      }

#pragma unroll
      for (int ki = 0; ki < 4; ++ki) {
        const int i = i0 + ty + 16 * ki;
        if (i >= rows) continue;
        T* yrow = y + (r0 + i) * xrow + (size_t)h * P;
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
          const int p = tx + 16 * kp;
          if (p < P) yrow[p] = from_f32<T>(acc[ki][kp]);
        }
      }
      __syncthreads();                    // s_c and s_h reads of this tile
    }

    // every row of the chunk has read the entering state: update it
    const float decay = expf(dac_last);
#pragma unroll
    for (int kp = 0; kp < 8; ++kp)
#pragma unroll
      for (int kn = 0; kn < 4; ++kn) {
        const int p = warp + 8 * kp, n = lane + 32 * kn;
        if (p < P && n < N)
          s_h[p * NP + n] = fmaf(s_h[p * NP + n], decay, upd[kp][kn]);
      }
    __syncthreads();
  }

  for (int i = tid; i < P * N; i += kThreads)
    h_out[bh * P * N + i] = s_h[(i / N) * NP + i % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* h_out, int B,
           int L, int H, int P, int N, int Q, cudaStream_t stream) {
  const int NP = N + 1;
  const size_t smem = sizeof(float) * (P * NP + 2 * kTile * NP + kTile * P +
                                       kTile * kMP + 3 * kMaxQ);
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_out), L, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L, H, P) and y; dt (B, L, H) f32, softplus'd; A (H,) f32; Bm, Cm
// (B, L, N) in x's type; h0 (B, H, P, N) f32 or null (zero state); h_out
// (B, H, P, N) f32.  Q = min(chunk, L).  All contiguous, on one device.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* h0, void* y, void* h_out, int B,
                               int L, int H, int P, int N, int Q, int dtype,
                               void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || Q <= 0 || Q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH_DTYPE(dtype, return launch<T>(x, dt, A, Bm, Cm, h0, y, h_out,
                                              B, L, H, P, N, Q,
                                              static_cast<cudaStream_t>(
                                                  stream)));
  return (int)cudaErrorInvalidValue;
}
