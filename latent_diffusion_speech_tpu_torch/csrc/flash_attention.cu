// K5: attention over (B, Tq, H, D) queries and (B, Tkv, H, D) keys/values,
// optionally causal, with f32 scores, softmax statistics and accumulator.
//
// Replaces: latent_diffusion_speech_tpu/ops/pallas/flash_attention.py,
// function `flash_attention` (kernel `_attn_kernel`).
//
// Numerics (the TPU kernel's): scores, the running max m, the normaliser l
// and the p @ v accumulator are f32, and p is NOT rounded to the input
// dtype (K4 and the XLA path round it); the output is acc / max(l, 1e-30),
// cast to the input dtype.  Key columns past Tkv are masked.  `causal`
// keeps key col <= query row, aligned top-left (row 0 sees key 0), as the
// TPU kernel does, also when Tq != Tkv (the XLA path aligns bottom-right
// instead).
//
// Two kernels, one per entry:
//
// flash_attention_bf16 (tensor cores; the serve path's).  What bounds it on
// this card: at the UNet's shapes a call does 0.01-0.8 GFLOP (q.k and p.v,
// 2 * 2 * Tq * Tkv * D per head) and moves 0.2-4 MB, under a microsecond of
// either at the card's peaks, so it is bound by latency (a warp's serial walk
// over the keys) and, back to back, by the host's launch; at B=4, T=1024 the
// q.k and p.v products dominate.  Design (attention_mma.cuh): a block of
// 64 query rows (four warps, 16 rows each); bf16 64-key K/V tiles
// double-buffered through shared memory by cp.async; S = Q K^T by
// mma.sync in f32, times scale (the TPU kernel scales the f32 q first: the
// two differ by f32 rounding only); one online-softmax update per tile; p
// stays f32 for p @ v as split hi + lo, both bf16, two MMAs into one f32
// accumulator (about 16 significant bits of p, against 8 if p were
// rounded).  A causal block stops at its last row's key, and a warp skips a
// tile that lies wholly past its last row.  A row whose keys are all masked
// so far keeps m = -inf, l = 0, acc = 0: its update subtracts 0, not -inf.
//
// flash_attention_f32 and flash_attention_simt_bf16 (CUDA cores, f32
// arithmetic, q scaled in f32 before q.k as the TPU kernel does; the f32 contract is atol 2e-5, which bf16 products cannot
// meet; the bf16 instantiation is a yardstick that no serve or training
// path calls).  Design: one block of NT = 128 threads (four warps) per
// (batch * head, tile of BQ = 32 query rows).  Lane i of every warp owns
// query row i of the tile: its scaled q row and its f32 accumulator live in
// registers.  The block streams BK = 64-key K/V tiles through shared memory
// (read through the (b, t, h) strides, so q/k/v may be views of a fused
// projection); warp w takes keys [16w, 16w + 16) of each tile, scores them,
// and runs one FlashAttention-2 update per 16 keys: new max, rescale (l,
// acc) once, accumulate exp(s - m) * v in f32.  A causal tile stops at its
// last row's key.  The four warps' (m, l, acc) of a row merge at the end:
// each scales by exp(m_w - m), the partial accumulators are summed through
// shared memory, and lane i of warp 0 writes row i.
//
// D is a template parameter (8, 32, 48 or 64); other head dims are refused.
// D = 8 is the general denoiser's block zoo, whose attention blocks take
// `attention_head_dim` (8 in Unit2Mel's config) as the head width.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#include "attention_mma.cuh"

namespace {

constexpr int BQ = 32;        // query rows per block (one per lane)
constexpr int KS = 4;         // warps per block, each taking a quarter of a key tile
constexpr int NT = BQ * KS;   // threads per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int KW = BK / KS;   // keys per warp per tile: one online-softmax update

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& dst, float x) { dst = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int Tq, int Tkv,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    float scale, int causal) {
  static_assert((KS - 1) * D * BQ <= 2 * BK * (D + 1), "the reduction must fit in the K/V tiles");
  __shared__ float smem[2 * BK * (D + 1)];  // the K and V tiles, then the reduction
  __shared__ float m_part[KS][BQ];
  __shared__ float l_part[KS][BQ];

  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*vs)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem + BK * (D + 1));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row = blockIdx.x * BQ + lane;

  float qr[D];
  const T* qp = q + b * sqb + (long long)min(row, Tq - 1) * sqt + h * sqh;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = to_f(qp[d]) * scale;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  float m = -INFINITY, l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  // keys past the tile's last row are masked for every row of a causal tile
  const int kv_end = causal ? min(Tkv, (int)blockIdx.x * BQ + BQ) : Tkv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int nk = min(BK, kv_end - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      ks[j][d] = to_f(kb[(long long)(k0 + j) * skt + d]);
      vs[j][d] = to_f(vb[(long long)(k0 + j) * svt + d]);
    }
    __syncthreads();
    const int j0 = w * KW;
    const int n = min(KW, nk - j0);  // this warp's keys in the tile (may be <= 0)
    if (n <= 0) continue;
    float s[KW];
    float m_tile = -INFINITY;
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      const bool ok = u < n && (!causal || k0 + j0 + u <= row);
      float dot = 0.f;
      if (u < n) {
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j0 + u][d], dot);
      }
      s[u] = ok ? dot : -INFINITY;
      m_tile = fmaxf(m_tile, s[u]);
    }
    if (m_tile == -INFINITY) continue;  // every key of this chunk masked for this row
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);  // 0 on the first update (m = -inf)
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      if (u < n && s[u] != -INFINITY) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j0 + u][d], acc[d]);
      }
    }
    m = m_new;
  }

  // merge the four warps' statistics of each row, then their accumulators
  m_part[w][lane] = m;
  l_part[w][lane] = l;
  __syncthreads();
  float m_all = -INFINITY;
#pragma unroll
  for (int i = 0; i < KS; ++i) m_all = fmaxf(m_all, m_part[i][lane]);
  float l_all = 0.f;
#pragma unroll
  for (int i = 0; i < KS; ++i)
    if (l_part[i][lane] > 0.f) l_all += l_part[i][lane] * expf(m_part[i][lane] - m_all);
  const float mine = l > 0.f ? expf(m - m_all) : 0.f;

  float* red = smem;  // (KS - 1) * D * BQ floats <= 2 * BK * (D + 1)
  __syncthreads();
  if (w > 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) red[((w - 1) * D + d) * BQ + lane] = acc[d] * mine;
  }
  __syncthreads();
  if (w == 0 && row < Tq) {
    const float denom = fmaxf(l_all, 1e-30f);
    T* op = out + (((long long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a = acc[d] * mine;
#pragma unroll
      for (int i = 0; i < KS - 1; ++i) a += red[(i * D + d) * BQ + lane];
      from_f(op[d], a / denom);
    }
  }
}

// ---- tensor cores (bf16)

template <int D>
__global__ void __launch_bounds__(lds_mma::NT) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int H, int Tq, int Tkv,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    float scale, int causal) {
  using lds_mma::BK, lds_mma::BM;  // this file's SIMT kernel has a BK of its own
  using lds_mma::LOG2E;
  using Dm = lds_mma::Dims<D>;
  using lds_mma::cp_async_commit, lds_mma::cp_async_wait, lds_mma::load_rows, lds_mma::load_q,
      lds_mma::qk_tile, lds_mma::scale_mask, lds_mma::quad_max, lds_mma::quad_sum, lds_mma::split_bf16,
      lds_mma::pv_step, lds_mma::store_rows;
  __shared__ __align__(16) lds_mma::Smem<D> sm;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM, wrow = q0 + 16 * w;  // the block's and the warp's first row
  const int row0 = wrow + (lane >> 2);                 // this thread's first fragment row
  const bool live = wrow < Tq;
  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + h * skh;
  const __nv_bfloat16* vb = v + b * svb + h * svh;
  // keys past the block's last row are masked for every row of a causal block,
  // and keys past the warp's last row for every row of the warp
  const int n_tiles = ((causal ? min(Tkv, q0 + BM) : Tkv) + BK - 1) / BK;
  const int kv_warp = causal ? min(Tkv, wrow + 16) : Tkv;

  load_rows<D, BM>(sm.q, qb, sqt, q0, Tq);
  cp_async_commit();
  load_rows<D, BK>(sm.k[0], kb, skt, 0, Tkv);
  load_rows<D, BK>(sm.v[0], vb, svt, 0, Tkv);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[Dm::KD][4];
  load_q<D>(qf, sm.q + 16 * w * Dm::DP, lane);

  float acc[Dm::ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < Dm::ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_rows<D, BK>(sm.k[(t + 1) & 1], kb, skt, (t + 1) * BK, Tkv);
      load_rows<D, BK>(sm.v[(t + 1) & 1], vb, svt, (t + 1) * BK, Tkv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int key0 = t * BK;
    if (live && key0 < kv_warp) {  // warp-uniform
      float s[8][4];
      qk_tile<D>(s, qf, sm.k[t & 1], lane);
      scale_mask(s, scale_log2, key0 + BK > Tkv || (causal && key0 + BK - 1 > wrow), key0, Tkv, row0,
                 causal, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // rows g and g + 8
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // every key so far masked
        const float alpha = exp2f(m[r] - m_use);               // 0 while m = -inf
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[n][2 * r] = exp2f(s[n][2 * r] - m_use);
          s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - m_use);
          sum += s[n][2 * r] + s[n][2 * r + 1];
        }
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < Dm::ND; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // 16 keys a k-step; steps with no live key skipped
        if (key0 + 16 * j >= kv_warp) break;
        uint32_t pa[2][4];
        split_bf16(s[2 * j][0], s[2 * j][1], pa[0][0], pa[1][0]);
        split_bf16(s[2 * j][2], s[2 * j][3], pa[0][1], pa[1][1]);
        split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], pa[0][2], pa[1][2]);
        split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], pa[0][3], pa[1][3]);
        pv_step<D, 2>(acc, pa, sm.v[t & 1], j, lane);
      }
    }
    __syncthreads();
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) den[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  if (live) store_rows<D>(out + ((long long)b * Tq * H + h) * D, (long long)H * D, acc, den, row0, Tq, lane);
}

// ---- launches

// One launch's arguments, packed by the Python wrapper (`ARGS` in
// ops/kernels/flash_attention.py, "<5q9q6if4x"): one ctypes argument
// instead of 21.  Strides are (q, k, v) x (b, t, h), in elements; the head
// dim is contiguous.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  void* stream;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  int B, Tq, Tkv, H, D, causal;
  float scale;
};
static_assert(sizeof(Args) == 144, "Args must match the wrapper's packing");
// each field where the wrapper packs it (tests/test_torch_attention_mma.py
// holds these offsets to the wrapper's `ARGS` and `ARG_NAMES`)
#define ARG_AT(field, offset) \
  static_assert(offsetof(Args, field) == (offset), "Args." #field " must sit where the wrapper packs it")
ARG_AT(q, 0);
ARG_AT(k, 8);
ARG_AT(v, 16);
ARG_AT(out, 24);
ARG_AT(stream, 32);
ARG_AT(sqb, 40);
ARG_AT(sqt, 48);
ARG_AT(sqh, 56);
ARG_AT(skb, 64);
ARG_AT(skt, 72);
ARG_AT(skh, 80);
ARG_AT(svb, 88);
ARG_AT(svt, 96);
ARG_AT(svh, 104);
ARG_AT(B, 112);
ARG_AT(Tq, 116);
ARG_AT(Tkv, 120);
ARG_AT(H, 124);
ARG_AT(D, 128);
ARG_AT(causal, 132);
ARG_AT(scale, 136);
#undef ARG_AT

template <typename T>
int launch_simt(const Args& a) {
  dim3 grid((a.Tq + BQ - 1) / BQ, a.B * a.H);
  dim3 block(NT);
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
#define LAUNCH_D(DV)                                                                          \
  flash_attention_kernel<T, DV><<<grid, block, 0, s>>>(                                       \
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),    \
      static_cast<T*>(a.out), a.H, a.Tq, a.Tkv, a.sqb, a.sqt, a.sqh, a.skb, a.skt, a.skh,     \
      a.svb, a.svt, a.svh, a.scale, a.causal)
  switch (a.D) {
    case 8: LAUNCH_D(8); break;
    case 32: LAUNCH_D(32); break;
    case 48: LAUNCH_D(48); break;
    case 64: LAUNCH_D(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_D
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const Args& a) {
  dim3 grid((a.Tq + lds_mma::BM - 1) / lds_mma::BM, a.B * a.H);
  dim3 block(lds_mma::NT);
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
#define LAUNCH_D(DV)                                                                          \
  flash_attention_mma_kernel<DV><<<grid, block, 0, s>>>(                                      \
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),         \
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.out), a.H, a.Tq,  \
      a.Tkv, a.sqb, a.sqt, a.sqh, a.skb, a.skt, a.skh, a.svb, a.svt, a.svh, a.scale, a.causal)
  switch (a.D) {
    case 8: LAUNCH_D(8); break;
    case 32: LAUNCH_D(32); break;
    case 48: LAUNCH_D(48); break;
    case 64: LAUNCH_D(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_D
  return static_cast<int>(cudaGetLastError());
}

Args unpack(const void* packed) {
  Args a;
  memcpy(&a, packed, sizeof a);
  return a;
}

}  // namespace

// The bf16 entry needs 16-byte aligned pointers and strides (cp.async).
extern "C" int flash_attention_bf16(const void* packed) { return launch_mma(unpack(packed)); }

extern "C" int flash_attention_simt_bf16(const void* packed) {
  return launch_simt<__nv_bfloat16>(unpack(packed));
}

extern "C" int flash_attention_f32(const void* packed) { return launch_simt<float>(unpack(packed)); }
