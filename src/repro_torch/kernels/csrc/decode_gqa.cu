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
// compute limits.  The whole cost is streaming the K/V rows the query
// may see out of device memory, and at serving shapes (a few hundred
// written rows per slot) that stream is short, so what decides the time
// is how many loads are in flight at once across the 132 SMs and how
// much latency each block pays before its first byte arrives.
//
// Design.  One tile loop, templated over the KV addressing (DenseKV /
// PagedKV in attn_common.cuh), so the two layouts differ only in where a
// key row and its position are found.  One block of four warps per
// (slot, kv group, split):
// * The needed-tile walk (build_tile_list): the block reads its range's
//   int32 positions once, keeps the 32-key tiles the query may see, and
//   walks only that list; a masked key's K/V is never read.
// * Split-KV for both layouts.  The dense kernel cuts the list into the
//   host's split count of equal shares (kernels/splits.py, from shapes
//   alone: about two blocks per SM); the paged kernel's splits are the
//   reference's table ranges.  Each split writes f32 partials (m,
//   l, acc), a split with no tile writes (NEG_INF, 0, 0), and
//   combine_splits_kernel merges them in split order; with one split the
//   block finishes in place.  No atomics: every merge order is fixed.
// * A ring of 32-key tiles in shared memory (TileRing): 16-byte cp.async
//   copies, zero-filled for masked keys, two or three tiles in flight
//   while one is computed, one barrier per tile.
// * The g query heads of the group sit scaled in shared memory (f32) and
//   every staged tile serves all of them, so each K/V byte leaves device
//   memory once per step (the TPU kernel's g-fold saving, kept).
// * The warp split of a tile: with g >= 4 each warp owns whole heads and
//   lane j scores key j.  With g < 4 the tile's keys are split across the
//   warps (4 / g key streams of 32 g / 4 keys, each with its own online-
//   softmax state, merged at the end in a fixed order), and the 4 / g
//   lanes of one key split its dot product, so no warp idles.  Scores,
//   softmax and P.V run on the CUDA cores in f32.
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
                      int nkv, int g, int wsplits, int table_ints,
                      int n_tiles, int window, float scale) {
  using Ring = TileRing<T, HD>;
  constexpr int KP = Ring::KP;
  constexpr int CE = Ring::kChunk;
  constexpr int NCH = Ring::kChunks;
  constexpr int ND = (HD + 31) / 32;  // P.V dims owned by one lane
  const int b = blockIdx.x / nkv;
  const int kvh = blockIdx.x % nkv;
  const int nh = nkv * g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = g * wsplits;       // (head, key stream) pairs
  const int KPW = 32 / wsplits;    // keys of a tile per stream
  const int kk = lane % KPW;       // this lane's key within its stream
  const int part = lane / KPW;     // and its share of the dot product

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ring ring{smem_raw};                                   // kStages slots
  float* q_s = reinterpret_cast<float*>(smem_raw + Ring::kBytes);  // g x HD
  float* m_s = q_s + g * HD;                             // P
  float* l_s = m_s + P;                                  // P
  float* acc_s = l_s + P;                                // P x HD
  unsigned* mask_s = reinterpret_cast<unsigned*>(acc_s + P * HD);  // n_tiles
  int* list_s = reinterpret_cast<int*>(mask_s + n_tiles);  // n_tiles
  int* n_s = list_s + n_tiles;                           // 1
  int* tbl_s = n_s + 1;                                  // table_ints

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

  // an idle slot (q_pos < 0) sees no key
  const int n =
      qp >= 0 ? build_tile_list(kv, qp, qp, window, mask_s, list_s, n_s) : 0;
  const int2 share = KV::kCutsList ? list_share(n, blockIdx.y, gridDim.y)
                                   : make_int2(0, n);
  const int cnt = share.y - share.x;
  const int* tiles = list_s + share.x;

#pragma unroll
  for (int i = 0; i < Ring::kStages - 1; ++i) {
    if (i < cnt) ring.load(kv, k, v, tiles[i], mask_s[tiles[i]], i);
    cp_async_commit();
  }
  for (int i = 0; i < cnt; ++i) {
    cp_async_wait<Ring::kStages - 2>();
    __syncthreads();  // tile i landed; tile i - 1's slot is free
    const int nx = i + Ring::kStages - 1;
    if (nx < cnt)
      ring.load(kv, k, v, tiles[nx], mask_s[tiles[nx]], nx % Ring::kStages);
    cp_async_commit();

    const int slot = i % Ring::kStages;
    const int* kp_t = ring.pos(slot);
    const T* k_t = ring.k(slot);
    const T* v_t = ring.v(slot);
    for (int p = warp; p < P; p += kWarps) {
      const int h = p % g, stream = p / g;
      const int j = stream * KPW + kk;
      const bool valid = row_sees(kp_t[j], qp, window);
      const float* qh = q_s + h * HD;
      const T* kj = k_t + j * KP;
      float s = 0.f;
      for (int c = part; c < NCH; c += wsplits) {
        float kx[CE], qx[CE];
        chunk_f32(kj + c * CE, kx);
#pragma unroll
        for (int e = 0; e < CE; e += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(qh + c * CE + e);
          qx[e] = t4.x;
          qx[e + 1] = t4.y;
          qx[e + 2] = t4.z;
          qx[e + 3] = t4.w;
        }
#pragma unroll
        for (int e = 0; e < CE; ++e) s += qx[e] * kx[e];
      }
      for (int o = KPW; o < 32; o <<= 1)
        s += __shfl_xor_sync(ATTN_FULL_MASK, s, o);
      s = valid ? s : ATTN_NEG_INF;

      float mx = s;
      for (int o = 1; o < KPW; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(ATTN_FULL_MASK, mx, o));
      const float m_prev = m_s[p];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      const float pj = valid ? expf(s - m_new) : 0.f;
      float psum = pj;
      for (int o = 1; o < KPW; o <<= 1)
        psum += __shfl_xor_sync(ATTN_FULL_MASK, psum, o);

      float a[ND];
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        const int d = lane + 32 * e;
        a[e] = d < HD ? acc_s[p * HD + d] * corr : 0.f;
      }
      const T* vt = v_t + stream * KPW * KP;
      for (int jj = 0; jj < KPW; ++jj) {
        const float pjj = __shfl_sync(ATTN_FULL_MASK, pj, jj);
#pragma unroll
        for (int e = 0; e < ND; ++e) {
          const int d = lane + 32 * e;
          if (d < HD) a[e] += pjj * to_f32(vt[jj * KP + d]);
        }
      }
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        const int d = lane + 32 * e;
        if (d < HD) acc_s[p * HD + d] = a[e];
      }
      __syncwarp();  // every lane has read m_s[p] / l_s[p]
      if (lane == 0) {
        m_s[p] = m_new;
        l_s[p] = l_s[p] * corr + psum;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the key streams of each head in a fixed order; with one split
  // finish acc / l here, else write this split's partials
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
           int nh, int nkv, int splits, int split_entries, int keys,
           int window, cudaStream_t stream) {
  const int g = nh / nkv;
  // key streams per tile: 4 / g when g divides 4 warps' worth of heads
  const int wsplits = g == 1 ? 4 : g == 2 ? 2 : 1;
  const int P = g * wsplits;
  const int table_ints = KV::table_ints(split_entries);
  const int n_tiles = (keys + kTileKeys - 1) / kTileKeys;
  const size_t smem = TileRing<T, HD>::kBytes +
                      sizeof(float) * (g * HD + 2 * P + P * HD) +
                      sizeof(int) * (2 * n_tiles + 1 + table_ints);
  auto kernel = decode_gqa_kernel<T, HD, KV>;
  cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B * nkv, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos), kv,
      static_cast<T*>(out), ws_m, ws_l, ws_acc, nkv, g, wsplits, table_ints,
      n_tiles, window, 1.0f / sqrtf((float)HD));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_combine<T>(ws_m, ws_l, ws_acc, static_cast<T*>(out),
                           B * nkv, g, splits, HD, 1, nkv, g, stream);
}

}  // namespace

// q (B, nh, hd); k, v (B, S, nkv, hd); q_pos (B,) int32; kv_pos (B, S)
// int32; out (B, nh, hd).  splits: the host's split-KV count
// (kernels/splits.py); with splits > 1, ws_m, ws_l (B * nkv, splits, g)
// and ws_acc (B * nkv, splits, g, hd) are f32 scratch.  All contiguous,
// on one device, k and v 16-byte aligned.
extern "C" int decode_gqa_launch(const void* q, const void* k, const void* v,
                                 const void* q_pos, const void* kv_pos,
                                 void* out, void* ws_m, void* ws_l,
                                 void* ws_acc, int B, int S, int nh, int nkv,
                                 int hd, int splits, int window, int dtype,
                                 void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || splits <= 0 || (splits > 1 && !ws_acc))
    return (int)cudaErrorInvalidValue;
  DenseKV kv{static_cast<const int*>(kv_pos), S, nkv, nullptr};
  ATTN_DISPATCH_DTYPE(dtype, ATTN_DISPATCH_HD(hd, return launch<T, HD>(
      q, k, v, q_pos, kv, out, static_cast<float*>(ws_m),
      static_cast<float*>(ws_l), static_cast<float*>(ws_acc), B, nh, nkv,
      splits, 0, S, window, static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}

// q (B, nh, hd); k_pool, v_pool (nb, bs, nkv, hd); q_pos (B,) int32;
// pos_pool (nb, bs) int32; block_tables (B, max_bps) int32; out (B, nh,
// hd).  splits / split_entries: the reference's fused_layout (splits and
// spb * fuse).  With splits > 1, ws_m, ws_l (B * nkv, splits, g) and
// ws_acc (B * nkv, splits, g, hd) are f32 scratch.  All contiguous, the
// pools 16-byte aligned.
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
      splits, split_entries, split_entries * bs, window,
      static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}
