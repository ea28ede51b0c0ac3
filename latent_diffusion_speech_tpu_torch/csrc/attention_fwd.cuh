// Self-attention tile routine shared by K4 (`attention_fwd.cu`, one launch
// per call) and the fused UNet forward (`unet_fwd.cu`, one phase of its
// persistent kernel).  `attention_tile` computes, for one (batch * head, tile
// of 32 query rows), non-causal softmax(q k^T * scale) v over all T keys.
//
// Design: one block of NT = 128 threads, four warps.  Lane i of every warp
// owns query row i of the tile (q and its output accumulator live in
// registers); warp w takes a quarter of the keys of each 64-key K/V tile
// that the block streams through shared memory, so any T works, and scores
// four keys at a time to keep independent FMA chains in flight.  Pass 1
// runs the online f32 softmax recurrence (running max and sum) over the
// warp's keys; the four partial (max, sum) pairs of a row merge into its
// log-sum-exp.  Pass 2 recomputes each score, forms the normalised
// probability, rounds it to the input dtype (as the TPU kernels do before
// p @ v) and accumulates p * v in f32; the four partial outputs of a row
// are summed through shared memory.  Inputs are read through (b, t, h)
// strides, so q/k/v may be views of a fused projection; D is a template
// parameter (32, 48 or 64).  The caller passes `smem`, at least
// attention_smem_floats(D) floats, and all NT threads of the block call the
// routine together (it synchronises the block).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace lds_attn {

constexpr int BQ = 32;        // query rows per block (one per lane)
constexpr int KS = 4;         // warps per block, each taking a quarter of the keys
constexpr int NT = BQ * KS;   // threads per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int KW = BK / KS;   // keys per warp per tile
constexpr int U = 4;          // keys scored together (independent FMA chains)

__host__ __device__ constexpr int attention_smem_floats(int D) {
  return 2 * BK * (D + 1) + 2 * KS * BQ;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& dst, float x) { dst = __float2bfloat16(x); }
// round an f32 value through the storage dtype
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// s[u] = (q . k_{j+u}) * scale for N consecutive keys of the tile
template <int D, int N>
__device__ __forceinline__ void scores(const float (&q)[D], const float (*ks)[D + 1], int j,
                                       float scale, float (&s)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) s[u] = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int u = 0; u < N; ++u) s[u] = fmaf(q[d], ks[j + u][d], s[u]);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) s[u] = __fmul_rn(s[u], scale);
}

__device__ __forceinline__ void online(float s, float& m, float& l) {
  if (s > m) {
    l = l * expf(m - s) + 1.f;
    m = s;
  } else {
    l += expf(s - m);
  }
}

template <typename T, int D, int N>
__device__ __forceinline__ void accumulate(const float (&q)[D], const float (*ks)[D + 1],
                                           const float (*vs)[D + 1], int j, float scale,
                                           float m, float inv_l, float (&acc)[D]) {
  float s[N];
  scores<D, N>(q, ks, j, scale, s);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const float p = round_to(expf(s[u] - m) * inv_l, T());
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j + u][d], acc[d]);
  }
}

// q/k/v are not __restrict__: in the fused UNet they were written earlier in
// the same launch, so they must not go through the read-only cache.
// out is contiguous (B, T, H, D); lse (B*H, T) is skipped when null.
template <typename T, int D>
__device__ __forceinline__ void attention_tile(
    const T* q, const T* k, const T* v, T* out, float* lse,
    int H, int T_len,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    float scale, int bh, int q_tile, float* smem) {
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*vs)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem + BK * (D + 1));
  float (*m_part)[BQ] = reinterpret_cast<float (*)[BQ]>(smem + 2 * BK * (D + 1));
  float (*l_part)[BQ] = reinterpret_cast<float (*)[BQ]>(smem + 2 * BK * (D + 1) + KS * BQ);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = bh / H, h = bh % H;
  const int row = q_tile * BQ + lane;
  const bool active = row < T_len;

  float qr[D];
  const T* qp = q + b * sqb + (long long)min(row, T_len - 1) * sqt + h * sqh;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = to_f(qp[d]);
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  // ---- pass 1: online softmax statistics over this warp's keys
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    const int nk = min(BK, T_len - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      ks[j][d] = to_f(kb[(long long)(k0 + j) * skt + d]);
    }
    __syncthreads();
    const int j1 = min(w * KW + KW, nk);
    int j = w * KW;
    for (; j + U <= j1; j += U) {
      float s[U];
      scores<D, U>(qr, ks, j, scale, s);
#pragma unroll
      for (int u = 0; u < U; ++u) online(s[u], m, l);
    }
    for (; j < j1; ++j) {
      float s[1];
      scores<D, 1>(qr, ks, j, scale, s);
      online(s[0], m, l);
    }
  }
  // merge the warps' partial statistics of each row
  m_part[w][lane] = m;
  l_part[w][lane] = l;
  __syncthreads();
  m = -INFINITY;
#pragma unroll
  for (int i = 0; i < KS; ++i) m = fmaxf(m, m_part[i][lane]);
  l = 0.f;
#pragma unroll
  for (int i = 0; i < KS; ++i)
    if (l_part[i][lane] > 0.f) l += l_part[i][lane] * expf(m_part[i][lane] - m);
  const float inv_l = 1.f / l;

  // ---- pass 2: p = exp(s - m) / l rounded to T, partial sum_j p_j v_j (f32)
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    const int nk = min(BK, T_len - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      ks[j][d] = to_f(kb[(long long)(k0 + j) * skt + d]);
      vs[j][d] = to_f(vb[(long long)(k0 + j) * svt + d]);
    }
    __syncthreads();
    const int j1 = min(w * KW + KW, nk);
    int j = w * KW;
    for (; j + U <= j1; j += U) accumulate<T, D, U>(qr, ks, vs, j, scale, m, inv_l, acc);
    for (; j < j1; ++j) accumulate<T, D, 1>(qr, ks, vs, j, scale, m, inv_l, acc);
  }

  // ---- sum the four partial outputs of each row (the K/V tiles are free now)
  __syncthreads();
  float* red = smem;  // (KS - 1) * D * BQ floats <= 2 * BK * (D + 1)
  if (w > 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) red[((w - 1) * D + d) * BQ + lane] = acc[d];
  }
  __syncthreads();
  if (w == 0 && active) {
    T* op = out + (((long long)b * T_len + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a = acc[d];
#pragma unroll
      for (int i = 0; i < KS - 1; ++i) a += red[(i * D + d) * BQ + lane];
      from_f(op[d], a);
    }
    if (lse != nullptr) lse[(long long)bh * T_len + row] = m + logf(l);
  }
  // the caller may reuse smem for its next tile
  __syncthreads();
}

}  // namespace lds_attn
