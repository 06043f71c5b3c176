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
// (C = 256) the 4 * hd flops per (query, key) dominate.  At serving
// shapes the K/V stream is short (a few hundred rows per slot), so the
// time is set by how many loads are in flight across the 132 SMs and by
// the arithmetic rate, not by the bytes alone.
//
// Design.  One tile loop, templated over the KV addressing (DenseKV /
// PagedKV in attn_common.cuh): the two layouts differ only in where a key
// row and its position are found.  The TPU kept a whole chunk resident
// per (slot, head) program.  Here the query heads of a GQA group share
// K/V, so the g * C query rows of one (slot, kv group) are packed into row
// tiles (row r = token r / g, head r % g) of 16 rows per warp and one to
// four warps: a block holds 16 * ceil(g C / 16) rows up to 64, so a verify
// chunk of 32 rows is not padded to 64.  The grid is (B * nkv, row tiles,
// KV splits).
// * The needed-tile walk (build_tile_list): the block reads its range's
//   int32 positions once, keeps the 32-key tiles that some row of the
//   block may see (from the rows' position range and the window), and
//   walks only that list; a masked key's K/V is never read.
// * Split-KV for both layouts.  The dense kernel cuts the list into the
//   host's split count of equal shares (kernels/splits.py, from shapes
//   alone: a chunk wider than 16 rows splits only a grid smaller than
//   the card, since its partials cost rows x hd f32 to write and merge);
//   the paged kernel's splits are the reference's table ranges.  Each split writes f32 partials (m,
//   l, acc), a split with no tile writes (NEG_INF, 0, 0), and
//   combine_splits_kernel merges them in split order; with one split the
//   block finishes in place.  No atomics.
// * A ring of 32-key tiles in shared memory (TileRing): 16-byte cp.async
//   copies, zero-filled for masked keys, two or three tiles in flight
//   while one is computed, one barrier per tile.
// * bf16 runs both products on the tensor cores: each warp's 16 rows are
//   one m16n8k16 fragment; Q's fragments stay in registers for the whole
//   walk; S = Q K^T and O += P V are mma.sync (bf16 in, f32 accumulate)
//   fed by ldmatrix (.trans for V) from the ring; the softmax scale is
//   applied to S in f32 after the product, and P is rounded to bf16 for
//   P V as FlashAttention does (the reference keeps P in f32; m, l and
//   the accumulator stay f32).  f32 inputs stay on f32 FMAs on the CUDA
//   cores (no TF32): thread t owns a 4 x 4 patch of the score tile (rows
//   4 (t / 8) .., keys t % 8 + 8 j), the 8 threads of a row group reduce
//   by shuffle and exchange P through shared memory with a warp barrier.
#include <type_traits>

#include "attn_common.cuh"

namespace {

constexpr int kMaxWarps = 4;
constexpr int kRowsPerWarp = 16;

// Output row (token r / g, head r % g) of group row r
__device__ __forceinline__ size_t out_row(int b, int C, int nh, int kvh,
                                          int g, int r) {
  return ((size_t)b * C + r / g) * nh + kvh * g + r % g;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core rows.  Warp w owns local rows 16 w .. 16 w + 15; in
// the mma fragment layout this lane holds rows lane / 4 and lane / 4 + 8
// of them ("lo" / "hi") at keys / dims 2 (lane % 4) + {0, 1} of every
// 8-wide fragment.
// ---------------------------------------------------------------------------
template <int HD>
struct MmaRows {
  using T = __nv_bfloat16;
  static constexpr int QP = HD + 8;   // q tile pitch: RingPitch's rule
  static constexpr int KS = HD / 16;  // k-steps of Q K^T
  static constexpr int NF = HD / 8;   // 8-wide dim fragments of O
  __host__ __device__ static size_t smem_bytes(int rows) {
    return (size_t)rows * QP * sizeof(T);
  }

  unsigned qa[KS][4];
  float o[NF][4];
  float m[2], l[2];
  int qp[2];

  // the block's q rows, unscaled, into shared memory (rows past the
  // group's R are zero); every thread
  __device__ static void stage(const T* __restrict__ q, unsigned char* raw,
                               int b, int C, int nh, int kvh, int g, int r0,
                               int R, int rows, float /*scale*/) {
    T* q_sm = reinterpret_cast<T*>(raw);
    constexpr int CH = HD / 8;
    for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
      const int lr = i / CH, c = i % CH, r = r0 + lr;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < R)
        x = *reinterpret_cast<const uint4*>(
            q + out_row(b, C, nh, kvh, g, r) * HD + c * 8);
      *reinterpret_cast<uint4*>(q_sm + lr * QP + c * 8) = x;
    }
  }

  __device__ void init(const unsigned char* raw, const int* qp_s) {
    const T* q_sm = reinterpret_cast<const T*>(raw);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mat = lane >> 3;
    const int row = warp * kRowsPerWarp + 8 * (mat & 1) + (lane & 7);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(q_sm + row * QP + 16 * ks + 8 * (mat >> 1), qa[ks][0],
              qa[ks][1], qa[ks][2], qa[ks][3]);
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = ATTN_NEG_INF;
      l[hr] = 0.f;
      qp[hr] = qp_s[warp * kRowsPerWarp + (lane >> 2) + 8 * hr];
    }
  }

  __device__ void tile(const int* kp_t, const T* k_t, const T* v_t,
                       int window, float scale, unsigned char* /*raw*/,
                       int /*rows*/) {
    constexpr int KP = RingPitch<T, HD>::value;
    const int lane = threadIdx.x & 31, mat = lane >> 3;
    // S = Q K^T: four 8-key fragments
    float sc[4][4];
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nf][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int key = 8 * (2 * np + (mat >> 1)) + (lane & 7);
        unsigned b0, b1, b2, b3;
        ldsm_x4(k_t + key * KP + 16 * ks + 8 * (mat & 1), b0, b1, b2, b3);
        mma_bf16(sc[2 * np], qa[ks], b0, b1);
        mma_bf16(sc[2 * np + 1], qa[ks], b2, b3);
      }
    }
    // scale in f32, mask, online softmax of rows lo / hi
    unsigned valid = 0u;
    float mx[2] = {ATTN_NEG_INF, ATTN_NEG_INF};
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const bool ok =
            row_sees(kp_t[8 * nf + 2 * (lane & 3) + (e & 1)], qp[hr], window);
        valid |= (ok ? 1u : 0u) << (4 * nf + e);
        sc[nf][e] = ok ? sc[nf][e] * scale : ATTN_NEG_INF;
        mx[hr] = fmaxf(mx[hr], sc[nf][e]);
      }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(ATTN_FULL_MASK, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(ATTN_FULL_MASK, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      corr[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = valid >> (4 * nf + e) & 1u
                            ? expf(sc[nf][e] - m[hr]) : 0.f;
        sc[nf][e] = p;
        ps[hr] += p;
      }
    // this lane's share of l; the four lanes of a row add theirs at the end
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + ps[hr];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      o[nf][0] *= corr[0];
      o[nf][1] *= corr[0];
      o[nf][2] *= corr[1];
      o[nf][3] *= corr[1];
    }
    // O += P V: P's C fragments are the A fragments of two 16-key steps
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const unsigned pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const int key = 16 * kk + 8 * (mat & 1) + (lane & 7);
#pragma unroll
      for (int nd = 0; nd < NF / 2; ++nd) {
        unsigned b0, b1, b2, b3;
        ldsm_x4_trans(v_t + key * KP + 8 * (2 * nd + (mat >> 1)), b0, b1, b2,
                      b3);
        mma_bf16(o[2 * nd], pa, b0, b1);
        mma_bf16(o[2 * nd + 1], pa, b2, b3);
      }
    }
  }

  __device__ void store(T* __restrict__ out, float* __restrict__ ws_m,
                        float* __restrict__ ws_l, float* __restrict__ ws_acc,
                        bool finish, size_t ws_row, int b, int C, int nh,
                        int kvh, int g, int r0, int R) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(ATTN_FULL_MASK, l[hr], 1);
      l[hr] += __shfl_xor_sync(ATTN_FULL_MASK, l[hr], 2);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + warp * kRowsPerWarp + (lane >> 2) + 8 * hr;
      if (r >= R) continue;
      const int d0 = 2 * (lane & 3);
      if (finish) {
        const float inv = 1.f / (l[hr] == 0.f ? 1.f : l[hr]);
        T* orow = out + out_row(b, C, nh, kvh, g, r) * HD + d0;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nf) =
              __floats2bfloat162_rn(o[nf][2 * hr] * inv,
                                    o[nf][2 * hr + 1] * inv);
      } else {
        float* a = ws_acc + (ws_row + r) * HD + d0;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
          *reinterpret_cast<float2*>(a + 8 * nf) =
              make_float2(o[nf][2 * hr], o[nf][2 * hr + 1]);
        if ((lane & 3) == 0) {
          ws_m[ws_row + r] = m[hr];
          ws_l[ws_row + r] = l[hr];
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// f32: CUDA-core rows.  Thread t owns local rows 4 (t / 8) .. + 3 and keys
// t % 8 + 8 j of each tile (interleaved, so the 8 threads of a row group
// read 8 distinct K rows in distinct banks), and dims t % 8 + 8 n of the
// output.
// ---------------------------------------------------------------------------
template <typename T, int HD>
struct FmaRows {
  static constexpr int QP = HD + 1;             // q_s pitch (floats)
  static constexpr int PP = kTileKeys + 1;      // p_s pitch (floats)
  static constexpr int ND = HD / 8;             // output dims per thread
  __host__ __device__ static size_t smem_bytes(int rows) {
    return sizeof(float) * (size_t)rows * (QP + PP);
  }

  float m[4], l[4], acc[4][ND];
  int qp[4];

  // the block's q rows, scaled, into shared memory as f32; every thread
  __device__ static void stage(const T* __restrict__ q, unsigned char* raw,
                               int b, int C, int nh, int kvh, int g, int r0,
                               int R, int rows, float scale) {
    float* q_s = reinterpret_cast<float*>(raw);
    for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
      const int lr = i / HD, d = i % HD, r = r0 + lr;
      q_s[lr * QP + d] =
          r < R ? to_f32(q[out_row(b, C, nh, kvh, g, r) * HD + d]) * scale
                : 0.f;
    }
  }

  __device__ void init(const unsigned char* /*raw*/, const int* qp_s) {
    const int rg = threadIdx.x / 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qp[i] = qp_s[rg * 4 + i];
      m[i] = ATTN_NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[i][n] = 0.f;
    }
  }

  __device__ void tile(const int* kp_t, const T* k_t, const T* v_t,
                       int window, float /*scale*/, unsigned char* raw,
                       int rows) {
    constexpr int KP = RingPitch<T, HD>::value;
    const float* q_s = reinterpret_cast<const float*>(raw);
    float* p_s = reinterpret_cast<float*>(raw) + rows * QP;
    const int rg = threadIdx.x / 8, kg = threadIdx.x % 8;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    const float* qrow = q_s + rg * 4 * QP;
    const T* krow = k_t + kg * KP;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qrow[i * QP + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kx[jj] = to_f32(krow[8 * jj * KP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] += qv[i] * kx[jj];
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool valid[4];
      float mx = ATTN_NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        valid[jj] = row_sees(kp_t[kg + 8 * jj], qp[i], window);
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
        p_s[(rg * 4 + i) * PP + kg + 8 * jj] = p;
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
    for (int j = 0; j < kTileKeys; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(rg * 4 + i) * PP + j];
      const T* vrow = v_t + j * KP + kg;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float vv = to_f32(vrow[8 * n]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] += pv[i] * vv;
      }
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

  __device__ void store(T* __restrict__ out, float* __restrict__ ws_m,
                        float* __restrict__ ws_l, float* __restrict__ ws_acc,
                        bool finish, size_t ws_row, int b, int C, int nh,
                        int kvh, int g, int r0, int R) {
    const int rg = threadIdx.x / 8, kg = threadIdx.x % 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + rg * 4 + i;
      if (r >= R) continue;
      if (!finish) {
        float* a = ws_acc + (ws_row + r) * HD + kg;
#pragma unroll
        for (int n = 0; n < ND; ++n) a[8 * n] = acc[i][n];
        if (kg == 0) {
          ws_m[ws_row + r] = m[i];
          ws_l[ws_row + r] = l[i];
        }
        continue;
      }
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      T* o = out + out_row(b, C, nh, kvh, g, r) * HD + kg;
#pragma unroll
      for (int n = 0; n < ND; ++n) o[8 * n] = from_f32<T>(acc[i][n] * inv);
    }
  }
};

template <typename T, int HD>
using RowsFor = typename std::conditional<
    std::is_same<T, __nv_bfloat16>::value, MmaRows<HD>, FmaRows<T, HD>>::type;

template <typename T, int HD, typename KV>
__global__ void __launch_bounds__(kMaxWarps * 32)
    partial_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ q_pos, KV kv,
                           T* __restrict__ out, float* __restrict__ ws_m,
                           float* __restrict__ ws_l,
                           float* __restrict__ ws_acc, int C, int nkv, int g,
                           int table_ints, int n_tiles, int window,
                           float scale) {
  using Ring = TileRing<T, HD>;
  using Rows = RowsFor<T, HD>;
  const int rows = blockDim.x / 32 * kRowsPerWarp;  // local rows
  const int b = blockIdx.x / nkv;
  const int kvh = blockIdx.x % nkv;
  const int nh = nkv * g;
  const int R = g * C;
  const int r0 = blockIdx.y * rows;
  const int tid = threadIdx.x, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ring ring{smem_raw};                                 // kStages slots
  unsigned char* rows_raw = smem_raw + Ring::kBytes;   // Rows::smem_bytes
  int* qp_s = reinterpret_cast<int*>(rows_raw + Rows::smem_bytes(rows));
  unsigned* mask_s = reinterpret_cast<unsigned*>(qp_s + rows);  // n_tiles
  int* list_s = reinterpret_cast<int*>(mask_s + n_tiles);       // n_tiles
  int* n_s = list_s + n_tiles;                                  // 1
  int* tbl_s = n_s + 1;                                         // table_ints

  kv.bind(b, kvh, blockIdx.z, tbl_s);
  Rows::stage(q, rows_raw, b, C, nh, kvh, g, r0, R, rows, scale);
  for (int lr = tid; lr < rows; lr += blockDim.x) {
    const int r = r0 + lr;
    qp_s[lr] = r < R ? q_pos[(size_t)b * C + r / g] : -1;
  }
  __syncthreads();
  // the rows' position range (every warp reduces it for itself)
  int qmin = 0x7fffffff, qmax = -1;
  for (int lr = lane; lr < rows; lr += 32) {
    const int p = qp_s[lr];
    if (p >= 0) {
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(ATTN_FULL_MASK, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(ATTN_FULL_MASK, qmax, o));
  }

  // padded rows only (q_pos < 0): no key is seen
  const int n = qmax >= 0
                    ? build_tile_list(kv, qmin, qmax, window, mask_s, list_s,
                                      n_s)
                    : 0;
  const int2 share = KV::kCutsList ? list_share(n, blockIdx.z, gridDim.z)
                                   : make_int2(0, n);
  const int cnt = share.y - share.x;
  const int* tiles = list_s + share.x;

  Rows acc;
  acc.init(rows_raw, qp_s);
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
    acc.tile(ring.pos(slot), ring.k(slot), ring.v(slot), window, scale,
             rows_raw, rows);
  }
  cp_async_wait<0>();

  // one KV split: finish acc / l here; else write this split's partials
  // (group blockIdx.x, split blockIdx.z, row r) for combine_splits_kernel
  const size_t ws_row = ((size_t)blockIdx.x * gridDim.z + blockIdx.z) * R;
  acc.store(out, ws_m, ws_l, ws_acc, gridDim.z == 1, ws_row, b, C, nh, kvh,
            g, r0, R);
}

template <typename T, int HD, typename KV>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           KV kv, void* out, float* ws_m, float* ws_l, float* ws_acc, int B,
           int C, int nh, int nkv, int splits, int split_entries, int keys,
           int window, cudaStream_t stream) {
  const int g = nh / nkv;
  const int R = g * C;
  // 16 rows per warp, one to four warps: a row tile fits g * C
  const int warps = min(kMaxWarps, (R + kRowsPerWarp - 1) / kRowsPerWarp);
  const int rows = warps * kRowsPerWarp;
  const int table_ints = KV::table_ints(split_entries);
  const int n_tiles = (keys + kTileKeys - 1) / kTileKeys;
  const size_t smem = TileRing<T, HD>::kBytes +
                      RowsFor<T, HD>::smem_bytes(rows) +
                      sizeof(int) * (rows + 2 * n_tiles + 1 + table_ints);
  auto kernel = partial_prefill_kernel<T, HD, KV>;
  cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * nkv, (R + rows - 1) / rows, splits);
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos), kv,
      static_cast<T*>(out), ws_m, ws_l, ws_acc, C, nkv, g, table_ints,
      n_tiles, window, 1.0f / sqrtf((float)HD));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_combine<T>(ws_m, ws_l, ws_acc, static_cast<T*>(out),
                           B * nkv, R, splits, HD, C, nkv, g, stream);
}

}  // namespace

// q (B, C, nh, hd); k, v (B', S, nkv, hd); q_pos (B, C) int32; kv_pos
// (B', S) int32; out (B, C, nh, hd).  slots: null (B' = B), or (B,) int32
// cache rows, query slot b attending over cache row slots[b] (a forward
// over some of the cache's slots).  splits: the host's split-KV count
// (kernels/splits.py); with splits > 1, ws_m, ws_l (B * nkv, splits, g *
// C) and ws_acc (B * nkv, splits, g * C, hd) are f32 scratch.  All
// contiguous, on one device, q, k and v 16-byte aligned.
extern "C" int partial_prefill_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* kv_pos, const void* slots,
                                      void* out, void* ws_m, void* ws_l,
                                      void* ws_acc, int B, int C, int S,
                                      int nh, int nkv, int hd, int splits,
                                      int window, int dtype, void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || splits <= 0 || (splits > 1 && !ws_acc))
    return (int)cudaErrorInvalidValue;
  DenseKV kv{static_cast<const int*>(kv_pos), S, nkv,
             static_cast<const int*>(slots)};
  ATTN_DISPATCH_DTYPE(dtype, ATTN_DISPATCH_HD(hd, return launch<T, HD>(
      q, k, v, q_pos, kv, out, static_cast<float*>(ws_m),
      static_cast<float*>(ws_l), static_cast<float*>(ws_acc), B, C, nh, nkv,
      splits, 0, S, window, static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}

// q (B, C, nh, hd); k_pool, v_pool (nb, bs, nkv, hd); q_pos (B, C) int32;
// pos_pool (nb, bs) int32; block_tables (B, max_bps) int32; out (B, C, nh,
// hd).  splits / split_entries: the reference's fused_layout (splits and
// spb * fuse).  With splits > 1, ws_m, ws_l (B * nkv, splits, g * C) and
// ws_acc (B * nkv, splits, g * C, hd) are f32 scratch.  All contiguous,
// q and the pools 16-byte aligned.
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
      splits, split_entries, split_entries * bs, window,
      static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}
