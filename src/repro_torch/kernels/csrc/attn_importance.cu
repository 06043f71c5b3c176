// Attention with fused importance extraction (Synera section 3.2).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/attn_importance/attn_importance.py:74
// attn_with_importance (body _attn_imp_kernel :36): exact-softmax
// attention of the query rows over the whole KV row, plus, per head, the
// column sums of the normalised softmax matrix.  Masks: kv_pos >= 0,
// q_pos >= 0, causal kv_pos <= q_pos; l == 0 -> 1.
//
// What bounds it on the card: latency.  On the device draft path it runs
// with one query token over a 512-slot cache at 12 heads of 64, 64-288
// slots filled: under 80 KB of K/V in bf16, a fraction of a microsecond
// of memory traffic.  What sets its time is the chain of dependent
// memory round trips each block waits on and the barriers between them.
//
// Design.  One block of four warps per (slot, query head), B * nh
// blocks; no split-KV, so there is no second launch and no merge.
// * The needed-tile walk (build_tile_list in attn_common.cuh): the block
//   reads the slot's int32 positions once and keeps the 32-key tiles that
//   some of its query rows may see; a masked key's K/V is never read.
//   The query rows are copied with cp.async beside that read, so the two
//   round trips overlap.
// * K is read once.  The block walks its tile list twice through one
//   ring of single-tensor tiles (kGroups groups of four slots, 16-byte
//   cp.async.cg copies, zero fill for keys outside the ballot): first the
//   K tiles, then the V tiles, as one stream of loads, so the V tiles are
//   already in flight while the scores are formed.  Tile i of a group
//   goes to warp i: the four warps take one row's tiles side by side.
// * Each row's scores for the listed tiles stay in shared memory (rows x
//   S f32).  Between the two walks every row's max and sum are reduced by
//   one warp in a fixed order (lane-strided, then a butterfly), and the
//   scores are replaced by the normalised p once.  That p feeds both P.V
//   and the column sums.
// * Determinism: the column sums feed OffloadPolicy.should_offload through
//   thresholds, so they must come out bit-identical on every run.  Each
//   listed tile belongs to one warp, whose lanes add its column over the
//   rows in row order; the warps' partial outputs are added in warp
//   order.  No atomics, no order that depends on timing.
// * Up to 16 query rows share one walk; with more rows (or less shared
//   memory at long S) the rows are taken in passes, each walking the list
//   again.  The draft step's single row takes an instance with one row
//   of registers.
#include "attn_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 16;              // query rows of one walk
constexpr int kRingBudget = 96 * 1024;    // bytes of the tile ring
constexpr int kSmemMax = 227 * 1024;

constexpr int clampi(int x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

// kGroups groups of kWarps slots; one slot holds one 32-key K or V tile
// at the padded pitch RingPitch.
template <typename T, int HD>
struct ImpRing {
  static constexpr int KP = RingPitch<T, HD>::value;
  static constexpr int kChunk = 16 / (int)sizeof(T);  // elements / copy
  static constexpr int kChunks = HD / kChunk;         // copies per row
  static constexpr int kSlotBytes = kTileKeys * KP * (int)sizeof(T);
  static constexpr int kGroups =
      clampi(kRingBudget / (kWarps * kSlotBytes), 2, 6);
  static constexpr int kBytes = kGroups * kWarps * kSlotBytes;

  unsigned char* base;
  __device__ T* slot(int i) const {
    return reinterpret_cast<T*>(base + i * kSlotBytes);
  }
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory carve-up of one block: every region starts 16-byte
// aligned.  R rows per walk, SP = S rounded up to 32.
template <typename T, int HD>
struct ImpSmem {
  int ring, q, col, sc, kp, mask, list, qp, total;
  __host__ __device__ ImpSmem(int S, int R) {
    const int SP = round_up(S, kTileKeys), n_tiles = SP / kTileKeys;
    ring = 0;
    q = ImpRing<T, HD>::kBytes;
    col = q + round_up(R * HD * (int)sizeof(T), 16);
    sc = col + SP * 4;
    kp = sc + R * SP * 4;
    mask = kp + SP * 4;
    list = mask + round_up(n_tiles * 4, 16);
    qp = list + round_up((n_tiles + 1) * 4, 16);
    total = qp + kMaxRows * 4;
  }
};

template <typename T, int HD, int MaxRows>
__global__ void __launch_bounds__(kThreads)
    attn_importance_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ q_pos,
                           const int* __restrict__ kv_pos,
                           T* __restrict__ out, float* __restrict__ imp,
                           int Tq, int S, int nh, int nkv, int causal,
                           int R, float scale) {
  using Ring = ImpRing<T, HD>;
  constexpr int KP = Ring::KP;
  constexpr int CE = Ring::kChunk;
  constexpr int NCH = Ring::kChunks;
  constexpr int ND = (HD + 31) / 32;   // P.V dims owned by one lane
  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int kvh = h / (nh / nkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int SP = round_up(S, kTileKeys);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ImpSmem<T, HD> lay(S, R);
  Ring ring{smem_raw + lay.ring};
  // after a walk the ring holds the warps' partial outputs (kWarps x R x
  // HD f32: never more than the ring's bytes)
  float* part_s = reinterpret_cast<float*>(smem_raw + lay.ring);
  T* q_s = reinterpret_cast<T*>(smem_raw + lay.q);            // R x HD
  float* col_s = reinterpret_cast<float*>(smem_raw + lay.col);  // SP
  float* sc_s = reinterpret_cast<float*>(smem_raw + lay.sc);    // R x SP
  int* kp_s = reinterpret_cast<int*>(smem_raw + lay.kp);        // SP
  unsigned* mask_s = reinterpret_cast<unsigned*>(smem_raw + lay.mask);
  int* list_s = reinterpret_cast<int*>(smem_raw + lay.list);
  int* n_s = list_s + SP / kTileKeys;
  int* qp_s = reinterpret_cast<int*>(smem_raw + lay.qp);        // R

  // rows t0 .. t0 + R - 1 of this head, raw, into q_s (one cp.async
  // group); rows past Tq are zero
  auto stage_q = [&](int t0) {
    for (int i = tid; i < R * (HD / CE); i += kThreads) {
      const int r = i / (HD / CE), c = i % (HD / CE);
      const bool fill = t0 + r < Tq;
      const size_t src =
          fill ? (((size_t)b * Tq + t0 + r) * nh + h) * HD + c * CE : 0;
      cp_async16(q_s + r * HD + c * CE, q + src, fill);
    }
    cp_async_commit();
    for (int r = tid; r < R; r += kThreads)
      qp_s[r] = t0 + r < Tq ? q_pos[(size_t)b * Tq + t0 + r] : -1;
  };
  stage_q(0);
  for (int i = tid; i < SP; i += kThreads) col_s[i] = 0.f;

  // the rows' position range (every warp reduces it for itself)
  int qmin = 0x7fffffff, qmax = -1;
  for (int t = lane; t < Tq; t += 32) {
    const int p = q_pos[(size_t)b * Tq + t];
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
  DenseKV kv{kv_pos, S, nkv, nullptr};
  kv.bind(b, kvh, 0, nullptr);
  // padded rows only: no key is seen.  Without the causal mask a row
  // sees every written key.
  const int n = qmax >= 0
                    ? build_tile_list(kv, qmin, causal ? qmax : 0x7fffffff,
                                      0, mask_s, list_s, n_s)
                    : 0;
  const int GK = (n + kWarps - 1) / kWarps;   // groups of K tiles
  const int G = 2 * GK;                       // then as many of V tiles

  // Starts the copies of group gi of the walk (K tiles, then V tiles;
  // tile u of the group into slot u of ring group gi % kGroups) and
  // commits them as one cp.async group, empty past the end.
  auto fetch = [&](int gi) {
    if (gi < G) {
      const bool is_v = gi >= GK;
      const int i0 = (is_v ? gi - GK : gi) * kWarps;
      const int cnt = min(kWarps, n - i0);
      const int slot0 = (gi % Ring::kGroups) * kWarps;
      const T* src = is_v ? v : k;
      for (int i = tid; i < cnt * kTileKeys * NCH; i += kThreads) {
        const int u = i / (kTileKeys * NCH);
        const int j = i / NCH % kTileKeys, c = i % NCH;
        const int t = list_s[i0 + u];
        const bool fill = mask_s[t] >> j & 1u;
        const size_t off =
            fill ? kv.row(t * kTileKeys + j) * HD + c * CE : 0;
        cp_async16(ring.slot(slot0 + u) + j * KP + c * CE, src + off, fill);
      }
      if (!is_v) {
        for (int i = tid; i < cnt * kTileKeys; i += kThreads) {
          const int li = i0 + i / kTileKeys, j = i % kTileKeys;
          const int t = list_s[li];
          if (mask_s[t] >> j & 1u)
            cp_async4(kp_s + li * kTileKeys + j,
                      kv.position_ptr(t * kTileKeys + j));
          else
            kp_s[li * kTileKeys + j] = -1;
        }
      }
    }
    cp_async_commit();
  };

  for (int t0 = 0; t0 < Tq; t0 += R) {
    const int rows = min(R, Tq - t0);
    if (t0 > 0) {
      __syncthreads();   // the last pass's q_s, p and partials are read
      stage_q(t0);
    }
    if (n == 0) {        // no key seen: the rows are 0
      for (int i = tid; i < rows * HD; i += kThreads)
        out[(((size_t)b * Tq + t0 + i / HD) * nh + h) * HD + i % HD] =
            from_f32<T>(0.f);
      continue;
    }
    float acc[MaxRows][ND];
#pragma unroll
    for (int r = 0; r < MaxRows; ++r)
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[r][e] = 0.f;

#pragma unroll
    for (int gi = 0; gi < Ring::kGroups - 1; ++gi) fetch(gi);
    for (int gi = 0; gi < G; ++gi) {
      // group gi (and the q rows) landed; group gi - 1's slots are free
      cp_async_wait<Ring::kGroups - 2>();
      __syncthreads();
      fetch(gi + Ring::kGroups - 1);
      if (gi == GK) {
        // every score is in place: per row, max and sum in a fixed order,
        // then the normalised p in place of the scores
        for (int r = warp; r < rows; r += kWarps) {
          float* sr = sc_s + r * SP;
          const int E = n * kTileKeys;
          float m = ATTN_NEG_INF;
          for (int e = lane; e < E; e += 32) m = fmaxf(m, sr[e]);
          m = warp_max(m);
          float l = 0.f;
          for (int e = lane; e < E; e += 32) {
            const float s = sr[e];
            const float p = s > ATTN_NEG_INF ? expf(s - m) : 0.f;
            sr[e] = p;
            l += p;
          }
          l = warp_sum(l);
          const float ls = l == 0.f ? 1.f : l;
          for (int e = lane; e < E; e += 32) sr[e] = sr[e] / ls;
        }
        __syncthreads();
      }
      const int li = (gi < GK ? gi : gi - GK) * kWarps + warp;
      if (li >= n) continue;
      const T* tile = ring.slot((gi % Ring::kGroups) * kWarps + warp);
      if (gi < GK) {
        // scores of the tile: lane j takes key j against every row
        float s[MaxRows];
#pragma unroll
        for (int r = 0; r < MaxRows; ++r) s[r] = 0.f;
        const T* kj = tile + lane * KP;
#pragma unroll 4
        for (int c = 0; c < NCH; ++c) {
          float kx[CE];
          chunk_f32(kj + c * CE, kx);
#pragma unroll
          for (int r = 0; r < MaxRows; ++r) {
            if (r >= rows) break;
            float qx[CE];
            chunk_f32(q_s + r * HD + c * CE, qx);
#pragma unroll
            for (int e = 0; e < CE; ++e) s[r] += qx[e] * kx[e];
          }
        }
        const int kp = kp_s[li * kTileKeys + lane];
#pragma unroll
        for (int r = 0; r < MaxRows; ++r) {
          if (r >= rows) break;
          const int qp = qp_s[r];
          const bool valid = kp >= 0 && qp >= 0 && (!causal || kp <= qp);
          sc_s[r * SP + li * kTileKeys + lane] =
              valid ? s[r] * scale : ATTN_NEG_INF;
        }
      } else {
        // P.V of the tile and its column sums over the rows, in row order
        const float* pt = sc_s + li * kTileKeys;
        float c = 0.f;
#pragma unroll
        for (int r = 0; r < MaxRows; ++r) {
          if (r >= rows) break;
          const float* pr = pt + r * SP;
          c += pr[lane];
#pragma unroll 8
          for (int jj = 0; jj < kTileKeys; ++jj) {
            const float pj = pr[jj];
#pragma unroll
            for (int e = 0; e < ND; ++e) {
              const int d = lane + 32 * e;
              if (d < HD) acc[r][e] += pj * to_f32(tile[jj * KP + d]);
            }
          }
        }
        const int key = list_s[li] * kTileKeys + lane;
        col_s[key] += c;
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free: the warps' partial outputs
#pragma unroll
    for (int r = 0; r < MaxRows; ++r) {
      if (r >= rows) break;
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        const int d = lane + 32 * e;
        if (d < HD) part_s[(warp * R + r) * HD + d] = acc[r][e];
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += part_s[(w * R + r) * HD + d];
      out[(((size_t)b * Tq + t0 + r) * nh + h) * HD + d] = from_f32<T>(o);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < S; i += kThreads)
    imp[((size_t)b * nh + h) * S + i] = col_s[i];
}

// Rows of one walk: one for the draft step, else as many as fit (up to
// kMaxRows); 0 when even one row's scores do not fit.
template <typename T, int HD>
int rows_per_walk(int Tq, int S) {
  int R = Tq == 1 ? 1 : min(Tq, kMaxRows);
  while (R > 0 && ImpSmem<T, HD>(S, R).total > kSmemMax) --R;
  return R;
}

template <typename T, int HD, int MaxRows>
int launch_rows(const void* q, const void* k, const void* v,
                const void* q_pos, const void* kv_pos, void* out, void* imp,
                int B, int Tq, int S, int nh, int nkv, int causal, int R,
                cudaStream_t stream) {
  const size_t smem = ImpSmem<T, HD>(S, R).total;
  auto kernel = attn_importance_kernel<T, HD, MaxRows>;
  cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * nh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<T*>(out),
      static_cast<float*>(imp), Tq, S, nh, nkv, causal, R,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* kv_pos, void* out, void* imp, int B, int Tq, int S,
           int nh, int nkv, int causal, cudaStream_t stream) {
  const int R = rows_per_walk<T, HD>(Tq, S);
  if (R == 0) return (int)cudaErrorInvalidValue;
  if (R == 1)
    return launch_rows<T, HD, 1>(q, k, v, q_pos, kv_pos, out, imp, B, Tq, S,
                                 nh, nkv, causal, R, stream);
  return launch_rows<T, HD, kMaxRows>(q, k, v, q_pos, kv_pos, out, imp, B,
                                      Tq, S, nh, nkv, causal, R, stream);
}

}  // namespace

// q (B, Tq, nh, hd); k, v (B, S, nkv, hd); q_pos (B, Tq) int32; kv_pos
// (B, S) int32; out (B, Tq, nh, hd); imp (B, nh, S) f32.  All contiguous,
// on one device, q, k and v 16-byte aligned.
extern "C" int attn_importance_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* kv_pos, void* out,
                                      void* imp, int B, int Tq, int S, int nh,
                                      int nkv, int hd, int causal, int dtype,
                                      void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || Tq <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH_DTYPE(dtype, ATTN_DISPATCH_HD(hd, return launch<T, HD>(
      q, k, v, q_pos, kv_pos, out, imp, B, Tq, S, nh, nkv, causal,
      static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}
