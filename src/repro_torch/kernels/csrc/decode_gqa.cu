// GQA decode attention: one query token per slot, over a dense cache or
// over the shared paged block pool through per-slot block tables.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_gqa/decode_gqa.py:71 decode_attention
//     (body _decode_kernel :29), and
//   src/repro/kernels/decode_gqa/decode_gqa.py:207 decode_attention_paged
//     (body _decode_paged_kernel :145) with its combine epilogue
//     src/repro/kernels/paged.py:102 combine_splits,
// with the same masks: kv_pos >= 0, kv_pos <= q_pos, optional sliding
// window, unmapped table entries / entries past the table, l == 0 -> 1.
//
// What bounds it on the card: bytes.  A decode step does 4 * hd flops per
// (head, key) and reads 2 * hd elements of K/V per (kv head, key), under
// one flop per byte, far below the ~295 flops/byte the H100 needs before
// compute limits.  The whole cost is streaming K/V from device memory --
// and, measured, the latency of each block's serial tile loads, since
// few blocks are in flight.
//
// Design: one tile loop, templated over the KV addressing (DenseKV /
// PagedKV in attn_common.cuh), so the two layouts differ only in where a
// key row and its position are found.  One block per (slot, kv group,
// split).  The g query heads of the group sit scaled in shared memory and
// every K/V tile is staged once for all of them, so each K/V byte leaves
// device memory once per step (the TPU kernel's g-fold saving, kept).
// Tiles whose positions are all masked (unwritten or unmapped rows, keys
// outside the window) are skipped after reading only their int32
// positions, and a masked key's K/V is never loaded.  The paged kernel
// first copies its split's block-table entries into shared memory, so
// the dependent load (entry, then row) costs its latency once per block.
// Inside a tile, each warp owns one (head, 32-key sub-tile) pair: lane j
// scores key j, the online-softmax state (m, l, acc) of the pair lives in
// shared memory in f32, and p_j is broadcast by shuffle for the P.V
// update.  When the group has fewer heads than warps (g = 1 for the
// paper's pair), the tile is split across warps and the per-warp partials
// are merged at the end, so no warp idles.  With more than one KV split
// (the reference's flash-decode split-KV) each block writes f32 partials
// and combine_splits_kernel merges them in split order.  No atomics: every
// merge order is fixed.
#include "attn_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T, int HD, typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ q_pos,
                      KV kv, T* __restrict__ out, float* __restrict__ ws_m,
                      float* __restrict__ ws_l, float* __restrict__ ws_acc,
                      int nkv, int g, int wsplits, int table_ints, int window,
                      float scale) {
  constexpr int KP = KPitch<T, HD>::value;
  constexpr int ND = (HD + 31) / 32;  // head dims owned by one lane
  const int b = blockIdx.x / nkv;
  const int kvh = blockIdx.x % nkv;
  const int nh = nkv * g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TK = 32 * wsplits;  // keys per tile
  const int P = g * wsplits;    // (head, sub-tile) pairs

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // g x HD, scaled
  float* m_s = q_s + g * HD;                         // P
  float* l_s = m_s + P;                              // P
  float* acc_s = l_s + P;                            // P x HD
  int* kp_s = reinterpret_cast<int*>(acc_s + P * HD);  // TK
  int* tbl_s = kp_s + TK;                            // table_ints
  T* k_s = reinterpret_cast<T*>(tbl_s + table_ints);  // TK x KP
  T* v_s = k_s + TK * KP;                            // TK x HD

  kv.bind(b, kvh, blockIdx.y, tbl_s);
  for (int i = tid; i < g * HD; i += kThreads) {
    const int h = i / HD, d = i % HD;
    q_s[i] = to_f32(q[((size_t)b * nh + kvh * g + h) * HD + d]) * scale;
  }
  for (int i = tid; i < P; i += kThreads) {
    m_s[i] = ATTN_NEG_INF;
    l_s[i] = 0.f;
  }
  for (int i = tid; i < P * HD; i += kThreads) acc_s[i] = 0.f;
  const int qp = q_pos[b];
  __syncthreads();  // table entries in place
  const int lo = kv.lo(), hi = kv.hi();

  for (int s0 = lo; s0 < hi; s0 += TK) {
    __syncthreads();  // previous tile fully consumed
    bool needed = false;
    if (tid < TK) {
      const int s = s0 + tid;
      const int kp = s < hi ? kv.position(s) : -1;
      kp_s[tid] = kp;
      needed = kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
    }
    if (!__syncthreads_or(needed)) continue;
    for (int i = tid; i < TK * HD; i += kThreads) {
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

    for (int p = warp; p < P; p += kWarps) {
      const int h = p % g, sub = p / g;
      const int j = sub * 32 + lane;
      const int kp = kp_s[j];
      const bool valid =
          kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
      const float* qh = q_s + h * HD;
      const T* kj = k_s + j * KP;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += qh[d] * to_f32(kj[d]);
      s = valid ? s : ATTN_NEG_INF;

      const float m_prev = m_s[p];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float corr = expf(m_prev - m_new);
      const float pj = valid ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(pj);

      float a[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        a[i] = d < HD ? acc_s[p * HD + d] * corr : 0.f;
      }
      const T* vt = v_s + sub * 32 * HD;
      for (int jj = 0; jj < 32; ++jj) {
        const float pjj = __shfl_sync(ATTN_FULL_MASK, pj, jj);
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) a[i] += pjj * to_f32(vt[jj * HD + d]);
        }
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) acc_s[p * HD + d] = a[i];
      }
      if (lane == 0) {
        m_s[p] = m_new;
        l_s[p] = l_s[p] * corr + psum;
      }
    }
  }
  __syncthreads();

  // merge the per-warp partials of each head in a fixed order; with one
  // KV split finish acc / l here, else write this split's partials
  const bool finish = gridDim.y == 1;
  const size_t ws_row = ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * g;
  for (int i = tid; i < g * HD; i += kThreads) {
    const int h = i / HD, d = i % HD;
    float m = ATTN_NEG_INF;
    for (int sp = 0; sp < wsplits; ++sp) m = fmaxf(m, m_s[sp * g + h]);
    float l = 0.f, acc = 0.f;
    for (int sp = 0; sp < wsplits; ++sp) {
      const int p = sp * g + h;
      const float w = expf(m_s[p] - m);
      l += l_s[p] * w;
      acc += acc_s[p * HD + d] * w;
    }
    if (finish) {
      l = l == 0.f ? 1.f : l;
      out[((size_t)b * nh + kvh * g + h) * HD + d] = from_f32<T>(acc / l);
    } else {
      ws_acc[(ws_row + h) * HD + d] = acc;
      if (d == 0) {
        ws_m[ws_row + h] = m;
        ws_l[ws_row + h] = l;
      }
    }
  }
}

template <typename T, int HD, typename KV>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           KV kv, void* out, float* ws_m, float* ws_l, float* ws_acc, int B,
           int nh, int nkv, int splits, int split_entries, int window,
           cudaStream_t stream) {
  const int g = nh / nkv;
  const int wsplits = g >= kWarps ? 1 : kWarps / g;
  const int TK = 32 * wsplits, P = g * wsplits;
  const int table_ints = KV::table_ints(split_entries);
  const size_t smem = sizeof(float) * (g * HD + 2 * P + P * HD) +
                      sizeof(int) * (TK + table_ints) +
                      sizeof(T) * TK * (KPitch<T, HD>::value + HD);
  auto kernel = decode_gqa_kernel<T, HD, KV>;
  cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B * nkv, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos), kv,
      static_cast<T*>(out), ws_m, ws_l, ws_acc, nkv, g, wsplits, table_ints,
      window, 1.0f / sqrtf((float)HD));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_combine<T>(ws_m, ws_l, ws_acc, static_cast<T*>(out),
                           B * nkv, g, splits, HD, 1, nkv, g, stream);
}

}  // namespace

// q (B, nh, hd); k, v (B, S, nkv, hd); q_pos (B,) int32; kv_pos (B, S)
// int32; out (B, nh, hd).  All contiguous, on one device.
extern "C" int decode_gqa_launch(const void* q, const void* k, const void* v,
                                 const void* q_pos, const void* kv_pos,
                                 void* out, int B, int S, int nh, int nkv,
                                 int hd, int window, int dtype,
                                 void* stream) {
  if (nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  DenseKV kv{static_cast<const int*>(kv_pos), S, nkv};
  ATTN_DISPATCH_DTYPE(dtype, ATTN_DISPATCH_HD(hd, return launch<T, HD>(
      q, k, v, q_pos, kv, out, nullptr, nullptr, nullptr, B, nh, nkv, 1, 0,
      window, static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}

// q (B, nh, hd); k_pool, v_pool (nb, bs, nkv, hd); q_pos (B,) int32;
// pos_pool (nb, bs) int32; block_tables (B, max_bps) int32; out (B, nh,
// hd).  splits / split_entries: the reference's fused_layout (splits and
// spb * fuse).  With splits > 1, ws_m, ws_l (B * nkv, splits, g) and
// ws_acc (B * nkv, splits, g, hd) are f32 scratch.  All contiguous.
extern "C" int decode_gqa_paged_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* q_pos,
    const void* pos_pool, const void* block_tables, void* out, void* ws_m,
    void* ws_l, void* ws_acc, int B, int nh, int nkv, int hd, int bs,
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
      static_cast<float*>(ws_l), static_cast<float*>(ws_acc), B, nh, nkv,
      splits, split_entries, window, static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}
