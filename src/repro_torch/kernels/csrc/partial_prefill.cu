// Chunked (partial) prefill attention, over a dense cache or over the
// shared paged block pool through per-slot block tables.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/partial_prefill/partial_prefill.py:78
//     partial_prefill_attention (body _pp_kernel :35), and
//   src/repro/kernels/partial_prefill/partial_prefill.py:204
//     partial_prefill_attention_paged (body _pp_paged_kernel :141) with its
//     combine epilogue src/repro/kernels/paged.py:102 combine_splits,
// with the same masks: kv_pos >= 0, q_pos >= 0, kv_pos <= q_pos, optional
// sliding window, unmapped table entries / entries past the table, and
// the l == 0 -> 1 guard, so padded query rows (q_pos = -1) come out as 0.
//
// What bounds it on the card: at verify widths (C = 8..32 queries per
// slot) bytes -- the K/V stream -- dominate; at prompt-prefill widths
// (C = 256) the 4 * hd flops per (query, key) dominate.  This first
// version does that arithmetic on the CUDA cores in f32 (the reference's
// precision for both dtypes); moving the two products onto the tensor
// cores (mma / wgmma) is the known next step.  Measured, the serial
// load-then-compute tile loop is latency-bound where few blocks run.
//
// Design: one tile loop, templated over the KV addressing (DenseKV /
// PagedKV in attn_common.cuh): the two layouts differ only in where a key
// row and its position are found.  The TPU kept a whole chunk resident
// per (slot, head) program.  Here C can be 256 and the query heads of a
// GQA group share K/V, so all g * C query rows of one (slot, kv group) are
// packed into 64-row tiles (row r = token r / g, head r % g); the grid is
// (B * nkv, row tiles, KV splits) and each block streams its key range in
// 32-key tiles with an online softmax.  One K/V tile in shared memory
// feeds every row of the tile.  A block first reduces its rows' position
// range and skips KV tiles that no row can attend to (unwritten or
// unmapped rows, future positions, keys outside the window) after reading
// only their int32 positions; a masked key's K/V is never loaded.  The
// paged kernel copies its split's block-table entries into shared memory
// first, so the dependent load (entry, then row) costs its latency once
// per block.  Thread t owns a 4 x 4 patch of the 64 x 32 score tile (rows
// 4 * (t / 8) .., keys 4 * (t % 8) ..); the 8 threads of a row group are
// one eighth of a warp, so row max / sum reduce by shuffle and the
// probabilities are exchanged through shared memory with only a warp
// barrier.  The same thread then owns those 4 rows of the output at dims
// t % 8 + 8 k.  With more than one KV split (the reference's flash-decode
// split-KV) each block writes f32 partials (m, l, acc) and
// combine_splits_kernel merges them in split order, without atomics.
#include "attn_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;  // query rows per block
constexpr int kKeys = 32;  // keys per KV tile

template <typename T, int HD, typename KV>
__global__ void __launch_bounds__(kThreads)
    partial_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ q_pos, KV kv,
                           T* __restrict__ out, float* __restrict__ ws_m,
                           float* __restrict__ ws_l,
                           float* __restrict__ ws_acc, int C, int nkv, int g,
                           int table_ints, int window, float scale) {
  constexpr int QP = HD + 1;                   // q_s pitch (floats)
  constexpr int KP = KPitch<T, HD>::value;     // k_s pitch (elements)
  constexpr int PP = kKeys + 1;                // p_s pitch (floats)
  constexpr int ND = HD / 8;                   // output dims per thread
  const int b = blockIdx.x / nkv;
  const int kvh = blockIdx.x % nkv;
  const int nh = nkv * g;
  const int rows = g * C;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int rg = tid / 8;  // row group: rows 4 rg .. 4 rg + 3
  const int kg = tid % 8;  // key group: keys 4 kg .. 4 kg + 3; dims kg + 8 k

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // kRows x QP
  float* p_s = q_s + kRows * QP;                      // kRows x PP
  int* qp_s = reinterpret_cast<int*>(p_s + kRows * PP);  // kRows
  int* kp_s = qp_s + kRows;                           // kKeys
  int* range_s = kp_s + kKeys;                        // [qmin, qmax]
  int* tbl_s = range_s + 2;                           // table entries
  T* k_s = reinterpret_cast<T*>(tbl_s + table_ints);  // kKeys x KP
  T* v_s = k_s + kKeys * KP;                          // kKeys x HD

  kv.bind(b, kvh, blockIdx.z, tbl_s);
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int lr = i / HD, d = i % HD;
    const int r = r0 + lr;
    float x = 0.f;
    if (r < rows) {
      const int c = r / g, h = r % g;
      x = to_f32(q[(((size_t)b * C + c) * nh + kvh * g + h) * HD + d]) * scale;
    }
    q_s[lr * QP + d] = x;
  }
  for (int lr = tid; lr < kRows; lr += kThreads) {
    const int r = r0 + lr;
    qp_s[lr] = r < rows ? q_pos[(size_t)b * C + r / g] : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int qmin = 0x7fffffff, qmax = -1;
    for (int lr = 0; lr < kRows; ++lr) {
      const int p = qp_s[lr];
      if (p >= 0) {
        qmin = min(qmin, p);
        qmax = max(qmax, p);
      }
    }
    range_s[0] = qmin;
    range_s[1] = qmax;
  }
  __syncthreads();
  const int qmin = range_s[0], qmax = range_s[1];
  const int lo = kv.lo(), hi = kv.hi();

  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qp[i] = qp_s[rg * 4 + i];
  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ATTN_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[i][n] = 0.f;
  }

  for (int s0 = lo; s0 < hi && qmax >= 0; s0 += kKeys) {
    __syncthreads();  // previous tile fully consumed
    bool needed = false;
    if (tid < kKeys) {
      const int s = s0 + tid;
      const int kp = s < hi ? kv.position(s) : -1;
      kp_s[tid] = kp;
      needed = kp >= 0 && kp <= qmax && (window == 0 || kp > qmin - window);
    }
    if (!__syncthreads_or(needed)) continue;
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      T kx = from_f32<T>(0.f), vx = from_f32<T>(0.f);
      if (kp_s[j] >= 0) {  // in range and mapped
        const size_t src = kv.row(s0 + j) * HD + d;
        kx = k[src];
        vx = v[src];
      }
      k_s[j * KP + d] = kx;
      v_s[j * HD + d] = vx;
    }
    __syncthreads();

    // scores for this thread's 4 x 4 patch
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    const float* qrow = q_s + rg * 4 * QP;
    const T* krow = k_s + kg * 4 * KP;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qrow[i * QP + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = to_f32(krow[jj * KP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] += qv[i] * kv[jj];
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool valid[4];
      float mx = ATTN_NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = kp_s[kg * 4 + jj];
        valid[jj] = kp >= 0 && qp[i] >= 0 && kp <= qp[i] &&
                    (window == 0 || qp[i] - kp < window);
        sc[i][jj] = valid[jj] ? sc[i][jj] : ATTN_NEG_INF;
        mx = fmaxf(mx, sc[i][jj]);
      }
      // reduce over the 8 threads of the row group (lanes differing in
      // their low three bits)
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(ATTN_FULL_MASK, mx, o));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = valid[jj] ? expf(sc[i][jj] - m_new) : 0.f;
        p_s[(rg * 4 + i) * PP + kg * 4 + jj] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        rs += __shfl_xor_sync(ATTN_FULL_MASK, rs, o);
      l[i] = l[i] * corr[i] + rs;
      m[i] = m_new;
    }
    __syncwarp();  // p_s rows of this row group are written by its warp

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[i][n] *= corr[i];
    for (int j = 0; j < kKeys; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(rg * 4 + i) * PP + j];
      const T* vrow = v_s + j * HD + kg;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float vv = to_f32(vrow[8 * n]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] += pv[i] * vv;
      }
    }
  }

  // one KV split: finish acc / l here; else write this split's partials
  // (group blockIdx.x, split blockIdx.z, row r) for combine_splits_kernel
  const size_t ws_row = ((size_t)blockIdx.x * gridDim.z + blockIdx.z) * rows;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + rg * 4 + i;
    if (r >= rows) continue;
    if (gridDim.z > 1) {
      float* a = ws_acc + (ws_row + r) * HD + kg;
#pragma unroll
      for (int n = 0; n < ND; ++n) a[8 * n] = acc[i][n];
      if (kg == 0) {
        ws_m[ws_row + r] = m[i];
        ws_l[ws_row + r] = l[i];
      }
      continue;
    }
    const int c = r / g, h = r % g;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* o = out + (((size_t)b * C + c) * nh + kvh * g + h) * HD + kg;
#pragma unroll
    for (int n = 0; n < ND; ++n) o[8 * n] = from_f32<T>(acc[i][n] * inv);
  }
}

template <typename T, int HD, typename KV>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           KV kv, void* out, float* ws_m, float* ws_l, float* ws_acc, int B,
           int C, int nh, int nkv, int splits, int split_entries, int window,
           cudaStream_t stream) {
  const int g = nh / nkv;
  const int table_ints = KV::table_ints(split_entries);
  const size_t smem =
      sizeof(float) * (kRows * (HD + 1) + kRows * (kKeys + 1)) +
      sizeof(int) * (kRows + kKeys + 2 + table_ints) +
      sizeof(T) * kKeys * (KPitch<T, HD>::value + HD);
  auto kernel = partial_prefill_kernel<T, HD, KV>;
  cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = g * C;
  const dim3 grid(B * nkv, (rows + kRows - 1) / kRows, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos), kv,
      static_cast<T*>(out), ws_m, ws_l, ws_acc, C, nkv, g, table_ints,
      window, 1.0f / sqrtf((float)HD));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_combine<T>(ws_m, ws_l, ws_acc, static_cast<T*>(out),
                           B * nkv, rows, splits, HD, C, nkv, g, stream);
}

}  // namespace

// q (B, C, nh, hd); k, v (B, S, nkv, hd); q_pos (B, C) int32; kv_pos
// (B, S) int32; out (B, C, nh, hd).  All contiguous, on one device.
extern "C" int partial_prefill_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* kv_pos, void* out, int B,
                                      int C, int S, int nh, int nkv, int hd,
                                      int window, int dtype, void* stream) {
  if (nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  DenseKV kv{static_cast<const int*>(kv_pos), S, nkv};
  ATTN_DISPATCH_DTYPE(dtype, ATTN_DISPATCH_HD(hd, return launch<T, HD>(
      q, k, v, q_pos, kv, out, nullptr, nullptr, nullptr, B, C, nh, nkv, 1,
      0, window, static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}

// q (B, C, nh, hd); k_pool, v_pool (nb, bs, nkv, hd); q_pos (B, C) int32;
// pos_pool (nb, bs) int32; block_tables (B, max_bps) int32; out (B, C, nh,
// hd).  splits / split_entries: the reference's fused_layout (splits and
// spb * fuse).  With splits > 1, ws_m, ws_l (B * nkv, splits, g * C) and
// ws_acc (B * nkv, splits, g * C, hd) are f32 scratch.  All contiguous.
extern "C" int partial_prefill_paged_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* q_pos,
    const void* pos_pool, const void* block_tables, void* out, void* ws_m,
    void* ws_l, void* ws_acc, int B, int C, int nh, int nkv, int hd, int bs,
    int max_bps, int splits, int split_entries, int window, int dtype,
    void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || bs <= 0 || splits <= 0 ||
      split_entries <= 0 || (splits > 1 && !ws_acc))
    return (int)cudaErrorInvalidValue;
  PagedKV kv{static_cast<const int*>(pos_pool),
             static_cast<const int*>(block_tables), bs, max_bps, nkv,
             split_entries};
  ATTN_DISPATCH_DTYPE(dtype, ATTN_DISPATCH_HD(hd, return launch<T, HD>(
      q, k_pool, v_pool, q_pos, kv, out, static_cast<float*>(ws_m),
      static_cast<float*>(ws_l), static_cast<float*>(ws_acc), B, C, nh, nkv,
      splits, split_entries, window, static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}
