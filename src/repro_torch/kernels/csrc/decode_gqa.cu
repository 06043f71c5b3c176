// GQA decode attention: one query token per slot against a dense cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_gqa/decode_gqa.py
// :71 decode_attention (body _decode_kernel :29), with the same masks:
// kv_pos >= 0, kv_pos <= q_pos, optional sliding window, l == 0 -> 1.
//
// What bounds it on the card: bytes.  A decode step does 4 * hd flops per
// (head, key) and reads 2 * hd elements of K/V per (kv head, key), under
// one flop per byte, far below the ~295 flops/byte the H100 needs before
// compute limits.  The whole cost is streaming K/V from device memory.
//
// Design: one block per (slot, kv group).  The g query heads of the group
// sit scaled in shared memory and every K/V tile is staged once for all
// of them, so each K/V byte leaves device memory once per step (the TPU
// kernel's g-fold saving, kept).  Tiles whose positions are all masked
// (the unwritten tail of the dense cache, or keys outside the window) are
// skipped after reading only their int32 positions.  Inside a tile, each
// warp owns one (head, 32-key sub-tile) pair: lane j scores key j, the
// online-softmax state (m, l, acc) of the pair lives in shared memory in
// f32, and p_j is broadcast by shuffle for the P.V update.  When the group
// has fewer heads than warps (g = 1 for the paper's pair), the tile is
// split across warps flash-decode style and the per-split partials are
// merged at the end, so no warp idles.  No atomics: the merge order is
// fixed.
#include "attn_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ q_pos,
                      const int* __restrict__ kv_pos, T* __restrict__ out,
                      int S, int nkv, int g, int splits, int window,
                      float scale) {
  constexpr int KP = KPitch<T, HD>::value;
  constexpr int ND = (HD + 31) / 32;  // head dims owned by one lane
  const int b = blockIdx.x / nkv;
  const int kvh = blockIdx.x % nkv;
  const int nh = nkv * g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TK = 32 * splits;  // keys per tile
  const int P = g * splits;    // (head, sub-tile) pairs

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // g x HD, scaled
  float* m_s = q_s + g * HD;                         // P
  float* l_s = m_s + P;                              // P
  float* acc_s = l_s + P;                            // P x HD
  int* kp_s = reinterpret_cast<int*>(acc_s + P * HD);  // TK
  T* k_s = reinterpret_cast<T*>(kp_s + TK);          // TK x KP
  T* v_s = k_s + TK * KP;                            // TK x HD

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

  for (int s0 = 0; s0 < S; s0 += TK) {
    __syncthreads();  // previous tile fully consumed
    bool needed = false;
    if (tid < TK) {
      const int s = s0 + tid;
      const int kp = s < S ? kv_pos[(size_t)b * S + s] : -1;
      kp_s[tid] = kp;
      needed = kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
    }
    if (!__syncthreads_or(needed)) continue;
    for (int i = tid; i < TK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const int s = s0 + j;
      T kv = from_f32<T>(0.f), vv = from_f32<T>(0.f);
      if (s < S) {
        const size_t src = (((size_t)b * S + s) * nkv + kvh) * HD + d;
        kv = k[src];
        vv = v[src];
      }
      k_s[j * KP + d] = kv;
      v_s[j * HD + d] = vv;
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

  // merge the per-split partials of each head in a fixed order
  for (int i = tid; i < g * HD; i += kThreads) {
    const int h = i / HD, d = i % HD;
    float m = ATTN_NEG_INF;
    for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, m_s[sp * g + h]);
    float l = 0.f, acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const int p = sp * g + h;
      const float w = expf(m_s[p] - m);
      l += l_s[p] * w;
      acc += acc_s[p * HD + d] * w;
    }
    l = l == 0.f ? 1.f : l;
    out[((size_t)b * nh + kvh * g + h) * HD + d] = from_f32<T>(acc / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* kv_pos, void* out, int B, int S, int nh, int nkv,
           int window, cudaStream_t stream) {
  const int g = nh / nkv;
  const int splits = g >= kWarps ? 1 : kWarps / g;
  const int TK = 32 * splits, P = g * splits;
  const size_t smem = sizeof(float) * (g * HD + 2 * P + P * HD) +
                      sizeof(int) * TK +
                      sizeof(T) * TK * (KPitch<T, HD>::value + HD);
  auto kernel = decode_gqa_kernel<T, HD>;
  cudaError_t err = attn_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * nkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<T*>(out), S, nkv, g,
      splits, window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
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
  ATTN_DISPATCH_DTYPE(dtype, ATTN_DISPATCH_HD(hd, return launch<T, HD>(
      q, k, v, q_pos, kv_pos, out, B, S, nh, nkv, window,
      static_cast<cudaStream_t>(stream))));
  return (int)cudaErrorInvalidValue;
}
