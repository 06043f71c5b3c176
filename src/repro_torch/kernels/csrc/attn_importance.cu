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
// with one query token over a 512-slot cache at 12 heads of 64 (1.6 MB
// of K/V in bf16): a few microseconds of memory traffic on 12 blocks.
// This version walks the row in 32-key tiles, twice, with a block
// barrier around every tile load, so its time is the latency of that
// serial chain (about 0.1 ms), not bytes or flops.  Spreading one row's
// key tiles across the warps (as decode_gqa.cu splits its tile) is the
// known next step.
//
// Design: the column sums are the point of the kernel and must be
// deterministic -- they feed OffloadPolicy.should_offload through
// thresholds, so a sum whose order changed from run to run would change
// offload decisions and token streams.  So there are no atomics: one block
// owns one (slot, head), loops over its query rows in tiles of 4 (one row
// per warp), and keeps the length-S column sum in shared memory (2 KB at
// S = 512, 16 KB at S = 4096).  Each row's softmax is exact, as on the
// TPU: a first pass over K finds the row max and sum, a second pass forms
// the normalised p, which goes into the P.V product and, through a fixed
// row order, into the column sums.  The TPU kept a (block_q, S) score
// tile resident; here only 32-key K/V tiles are staged.
#include "attn_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    attn_importance_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ q_pos,
                           const int* __restrict__ kv_pos,
                           T* __restrict__ out, float* __restrict__ imp,
                           int Tq, int S, int nh, int nkv, int causal,
                           float scale) {
  constexpr int KP = KPitch<T, HD>::value;
  constexpr int ND = (HD + 31) / 32;
  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int kvh = h / (nh / nkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* col_s = reinterpret_cast<float*>(smem_raw);  // S
  float* q_s = col_s + S;                              // kWarps x HD
  float* p_s = q_s + kWarps * HD;                      // kWarps x kKeys
  int* kp_s = reinterpret_cast<int*>(p_s + kWarps * kKeys);  // kKeys
  T* k_s = reinterpret_cast<T*>(kp_s + kKeys);        // kKeys x KP
  T* v_s = k_s + kKeys * KP;                          // kKeys x HD

  for (int i = tid; i < S; i += kThreads) col_s[i] = 0.f;

  // stage one KV tile (K always, V on the second pass) and its positions
  auto load_tile = [&](int s0, bool with_v) {
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const int s = s0 + j;
      T kv = from_f32<T>(0.f), vv = from_f32<T>(0.f);
      if (s < S) {
        const size_t src = (((size_t)b * S + s) * nkv + kvh) * HD + d;
        kv = k[src];
        if (with_v) vv = v[src];
      }
      k_s[j * KP + d] = kv;
      if (with_v) v_s[j * HD + d] = vv;
    }
    if (tid < kKeys) {
      const int s = s0 + tid;
      kp_s[tid] = s < S ? kv_pos[(size_t)b * S + s] : -1;
    }
  };

  for (int t0 = 0; t0 < Tq; t0 += kWarps) {
    const int t = t0 + warp;  // this warp's query row
    const int qp = t < Tq ? q_pos[(size_t)b * Tq + t] : -1;
    __syncthreads();  // previous tile's q_s no longer read
    for (int i = tid; i < kWarps * HD; i += kThreads) {
      const int w = i / HD, d = i % HD;
      const int tt = t0 + w;
      q_s[i] = tt < Tq
                   ? to_f32(q[(((size_t)b * Tq + tt) * nh + h) * HD + d]) * scale
                   : 0.f;
    }
    const float* qw = q_s + warp * HD;

    // pass 1: exact row max and sum
    float m = ATTN_NEG_INF, l = 0.f;
    for (int s0 = 0; s0 < S; s0 += kKeys) {
      __syncthreads();
      load_tile(s0, false);
      __syncthreads();
      const int kp = kp_s[lane];
      const bool valid = kp >= 0 && qp >= 0 && (!causal || kp <= qp);
      const T* kj = k_s + lane * KP;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += qw[d] * to_f32(kj[d]);
      s = valid ? s : ATTN_NEG_INF;
      const float m_new = fmaxf(m, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      l = l * expf(m - m_new) + warp_sum(p);
      m = m_new;
    }
    const float l_safe = l == 0.f ? 1.f : l;

    // pass 2: normalised p -> output rows and column sums
    float a[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) a[i] = 0.f;
    for (int s0 = 0; s0 < S; s0 += kKeys) {
      __syncthreads();
      load_tile(s0, true);
      __syncthreads();
      const int kp = kp_s[lane];
      const bool valid = kp >= 0 && qp >= 0 && (!causal || kp <= qp);
      const T* kj = k_s + lane * KP;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += qw[d] * to_f32(kj[d]);
      const float p = valid ? expf(s - m) / l_safe : 0.f;
      p_s[warp * kKeys + lane] = p;
      for (int jj = 0; jj < kKeys; ++jj) {
        const float pj = __shfl_sync(ATTN_FULL_MASK, p, jj);
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) a[i] += pj * to_f32(v_s[jj * HD + d]);
        }
      }
      __syncthreads();
      if (tid < kKeys && s0 + tid < S) {
        float c = col_s[s0 + tid];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) c += p_s[w * kKeys + tid];
        col_s[s0 + tid] = c;
      }
    }
    if (t < Tq) {
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        if (d < HD)
          out[(((size_t)b * Tq + t) * nh + h) * HD + d] = from_f32<T>(a[i]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < S; i += kThreads)
    imp[((size_t)b * nh + h) * S + i] = col_s[i];
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* kv_pos, void* out, void* imp, int B, int Tq, int S,
           int nh, int nkv, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (S + kWarps * HD + kWarps * kKeys) +
                      sizeof(int) * kKeys +
                      sizeof(T) * kKeys * (KPitch<T, HD>::value + HD);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = attn_importance_kernel<T, HD>;
  cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * nh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<T*>(out),
      static_cast<float*>(imp), Tq, S, nh, nkv, causal,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Tq, nh, hd); k, v (B, S, nkv, hd); q_pos (B, Tq) int32; kv_pos
// (B, S) int32; out (B, Tq, nh, hd); imp (B, nh, S) f32.  All contiguous,
// on one device.
extern "C" int attn_importance_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* kv_pos, void* out,
                                      void* imp, int B, int Tq, int S, int nh,
                                      int nkv, int hd, int causal, int dtype,
                                      void* stream) {
  if (nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH_DTYPE(dtype, ATTN_DISPATCH_HD(hd, return launch<T, HD>(
      q, k, v, q_pos, kv_pos, out, imp, B, Tq, S, nh, nkv, causal,
      static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}
