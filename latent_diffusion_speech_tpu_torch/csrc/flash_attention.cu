// K5: attention over (B, Tq, H, D) queries and (B, Tkv, H, D) keys/values,
// optionally causal, with f32 scores, softmax statistics and accumulator.
//
// Replaces: latent_diffusion_speech_tpu/ops/pallas/flash_attention.py,
// function `flash_attention` (kernel `_attn_kernel`).
//
// Numerics (the TPU kernel's): q is cast to f32 and multiplied by `scale`
// before q.k; scores, the running max m, the normaliser l and the p @ v
// accumulator are f32, and p is NOT rounded to the input dtype (K4 and the
// XLA path round it); the output is acc / max(l, 1e-30), cast to the input
// dtype.  Key columns past Tkv are masked.  `causal` keeps key col <= query
// row, aligned top-left (row 0 sees key 0), as the TPU kernel does, also
// when Tq != Tkv (the XLA path aligns bottom-right instead).
//
// What bounds it on this card: at the UNet's shapes (T = 56..448, D = 32..64,
// H = 8, B = 1..4) a call moves 0.2-4 MB and does 0.01-0.8 GFLOP (q.k and
// p.v, 2 * 2 * Tq * Tkv * D per head), well under a microsecond of either
// at the card's peaks, so it is bound by latency and occupancy (16-448
// blocks, short loops on the CUDA cores) and, launched back to back, by
// the host's launch; at T = 1024 it does ~1 GFLOP at B=1 on the CUDA
// cores (no tensor cores yet).  The TPU kernel walked its k/v blocks
// through VMEM in a sequential grid dimension; here that dimension is a
// loop inside the block.
//
// Design: one block of NT = 128 threads (four warps) per (batch * head, tile
// of BQ = 32 query rows).  Lane i of every warp owns query row i of the tile:
// its scaled q row and its f32 accumulator live in registers.  The block
// streams BK = 64-key K/V tiles through shared memory (read through the
// (b, t, h) strides, so q/k/v may be views of a fused projection); warp w
// takes keys [16w, 16w + 16) of each tile, scores them, and runs one
// FlashAttention-2 update per 16 keys: new max, rescale (l, acc) once,
// accumulate exp(s - m) * v in f32.  A causal tile stops at its last row's
// key.  The four warps' (m, l, acc) of a row merge at the end: each scales
// by exp(m_w - m), the partial accumulators are summed through shared
// memory, and lane i of warp 0 writes row i.  D is a template parameter
// (32, 48 or 64); other head dims are refused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

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

static_assert((KS - 1) * 64 * BQ <= 2 * BK * (64 + 1), "the reduction must fit in the K/V tiles");

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           int B, int Tq, int Tkv, int H, int D, const long long* st,
           float scale, int causal, void* stream) {
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  dim3 block(NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_D(DV)                                                              \
  flash_attention_kernel<T, DV><<<grid, block, 0, s>>>(                           \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), \
      static_cast<T*>(out), H, Tq, Tkv, st[0], st[1], st[2], st[3], st[4], st[5],  \
      st[6], st[7], st[8], scale, causal)
  switch (D) {
    case 32: LAUNCH_D(32); break;
    case 48: LAUNCH_D(48); break;
    case 64: LAUNCH_D(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_D
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 9 int64 (q, k, v) x (b, t, h), in elements; the head dim is contiguous.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int Tq, int Tkv, int H, int D, const long long* strides,
                                    float scale, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Tq, Tkv, H, D, strides, scale, causal, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int Tq, int Tkv, int H, int D, const long long* strides,
                                   float scale, int causal, void* stream) {
  return launch<float>(q, k, v, out, B, Tq, Tkv, H, D, strides, scale, causal, stream);
}
