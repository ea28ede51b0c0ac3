// K1: the whole RoFormer autoregressive decode in one kernel launch.
//
// Replaces: latent_diffusion_speech_tpu/ops/pallas/ar_decode.py, function
// `roformer_decode_pallas` (body `_decode_kernel`).
//
// What bounds it on this card: a decode step is a chain of matrix-vector
// products (per stream ~1.8 M multiply-adds at the flagship width, C=256,
// I=512, V=4099) whose weights (~3 MB in bf16, most of it the tied LM head)
// are read once per step and per stream; with one stream per SM this is
// bound by L2 latency and bandwidth into one SM, not by arithmetic.  A
// generation is hundreds of dependent steps; run as separate PyTorch ops
// (the plain loop) each step is ~40 launches and is bound by launch
// overhead instead.
//
// Design: one thread block per stream (grid = B), 512 threads, and the loop
// over the N steps inside the kernel, so a whole generation is one launch.
// Streams are independent, so there is no batch or memory gate: weights stay
// in global memory / L2 (shared by all blocks), the KV cache (f32) and the
// repetition mask live in global scratch the wrapper allocates, and the
// step's vectors, attention scores and logits live in shared memory.  Each
// matrix-vector product gives each warp eight output rows at a time (16-byte
// loads of the rows, all issued before the FMAs, warp-shuffle sums).  Matrix
// products accumulate in f32 and round to the model dtype; LayerNorm,
// softmax and the logit processors run in f32, in the plain loop's order
// (repetition penalty -> ban -> end gate -> temperature -> fused top-k/top-p).
// Sampling is Gumbel-max with Philox-4x32-10 noise keyed by
// (seed, stream, step, vocab index); argmax breaks ties to the lowest index.
// A stream stops at its EOS and fills the rest with PAD.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

struct ArDecodeArgs {
  const float* emb_eff;    // (V, C) f32: semantic embedding + type-0 embedding
  const void* emb;         // (V, C) T: tied LM head
  const float* head_bias;  // (V,) f32
  const float* sin_t;      // (N, D) f32
  const float* cos_t;      // (N, D) f32
  const float* emb_ln;     // (2, C) f32: scale, bias
  const void* ht_w;        // (C, C) T  (out, in)
  const void* ht_b;        // (C,) T
  const float* head_ln;    // (2, C)
  const void* wq; const void* bq; const void* wk; const void* bk;   // (nl, C, C), (nl, C)
  const void* wv; const void* bv; const void* wo; const void* bo;
  const float* self_ln;    // (nl, 2, C)
  const void* cq_w; const void* cq_b; const void* co_w; const void* co_b;
  const float* cross_ln;   // (nl, 2, C)
  const void* ff_in_w;     // (nl, I, C)
  const void* ff_in_b;     // (nl, I)
  const void* ff_out_w;    // (nl, C, I)
  const void* ff_out_b;    // (nl, C)
  const float* ff_ln;      // (nl, 2, C)
  const void* cross_k;     // (nl, B, L, C) T
  const void* cross_v;
  const int* cross_len;    // (B,)
  float* k_cache;          // (nl, B, N, C) f32 scratch
  float* v_cache;
  unsigned char* rep;      // (B, V) scratch: token already generated
  int* tokens;             // (B, N) out
  int* lengths;            // (B,) out
  float* debug_logits;     // (B, N, V) raw logits per step, or null
  unsigned long long seed;
  int B, C, H, I, V, L, N, nl;
  int do_sample, top_k, use_end_gate, eos, pad, bos, ban_until;
  float eps, scale, temperature, top_p, repetition_penalty, end_gate;
};

namespace {

constexpr int NT = 512;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int ROWS = 8;        // matrix rows in flight per warp
constexpr int MAX_TOP_K = 64;

__device__ __forceinline__ float rnd(float x, float) { return x; }
__device__ __forceinline__ float rnd(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float ldf(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// red: >= 33 floats of shared scratch
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < NW ? red[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < NW ? red[threadIdx.x] : -INFINITY;
    t = warp_max(t);
    if (threadIdx.x == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// argmax over (value, index) pairs, ties to the lowest index
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}
__device__ int block_argmax(float v, int i, float* redf, int* redi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    argmax_merge(v, i, v2, i2);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) { redf[threadIdx.x >> 5] = v; redi[threadIdx.x >> 5] = i; }
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < NW ? redf[threadIdx.x] : -INFINITY;
    int ti = threadIdx.x < NW ? redi[threadIdx.x] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float v2 = __shfl_xor_sync(0xffffffffu, t, o);
      int i2 = __shfl_xor_sync(0xffffffffu, ti, o);
      argmax_merge(t, ti, v2, i2);
    }
    if (threadIdx.x == 0) redi[32] = ti;
  }
  __syncthreads();
  return redi[32];
}

// the 16-byte vector w as f32 values: 8 bf16 or 4 f32 elements
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  f[0] = __uint_as_float(w.x << 16); f[1] = __uint_as_float(w.x & 0xffff0000u);
  f[2] = __uint_as_float(w.y << 16); f[3] = __uint_as_float(w.y & 0xffff0000u);
  f[4] = __uint_as_float(w.z << 16); f[5] = __uint_as_float(w.z & 0xffff0000u);
  f[6] = __uint_as_float(w.w << 16); f[7] = __uint_as_float(w.w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x); f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z); f[3] = __uint_as_float(w.w);
}

// 4 consecutive elements as f32 (8- or 16-byte load)
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// y[o] = round_T(sum_i x[i] W[o, i] + bias[o]) (+ post[o] in f32 after the
// rounding, for the LM head's f32 bias).  W is (out, in) row-major, x in
// shared memory.  One warp per ROWS rows: each lane takes 16-byte slices of
// the rows (lane-strided), all ROWS loads issued before the FMAs, then a
// warp-shuffle sum per row.  `in` must be a multiple of 8 (bf16) / 4 (f32).
template <typename T>
__device__ void gemv(const T* __restrict__ W, const T* __restrict__ bias,
                     const float* __restrict__ post, const float* __restrict__ x,
                     int in, int out, float* __restrict__ y) {
  constexpr int VN = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o0 = warp * ROWS; o0 < out; o0 += NW * ROWS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int i = lane * VN; i < in; i += 32 * VN) {
      uint4 w[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        w[r] = (o0 + r < out) ? *reinterpret_cast<const uint4*>(W + (long long)(o0 + r) * in + i)
                              : make_uint4(0u, 0u, 0u, 0u);
      float xv[VN];
#pragma unroll
      for (int e = 0; e < VN; e += 4) {
        const float4 t = *reinterpret_cast<const float4*>(x + i + e);
        xv[e] = t.x; xv[e + 1] = t.y; xv[e + 2] = t.z; xv[e + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float wf[VN];
        unpack(w[r], wf);
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[r] = fmaf(xv[e], wf[e], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = warp_sum(acc[r]);
    if (lane < ROWS && o0 + lane < out) {
      float a = acc[0];
#pragma unroll
      for (int r = 1; r < ROWS; ++r) if (lane == r) a = acc[r];
      const int o = o0 + lane;
      float v = rnd(a + (bias ? ldf(bias, o) : 0.f), T());
      if (post) v += post[o];
      y[o] = v;
    }
  }
}

// dst[c] = round_T(LN(src)[c]); src, dst in shared memory (may alias)
template <typename T>
__device__ void layer_norm(const float* src, float* dst, const float* g, const float* b,
                           int C, float eps, float* red) {
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += NT) s += src[c];
  const float mean = block_sum(s, red) / C;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < C; c += NT) { const float d = src[c] - mean; s2 += d * d; }
  const float rstd = rsqrtf(block_sum(s2, red) / C + eps);
  for (int c = threadIdx.x; c < C; c += NT)
    dst[c] = rnd((src[c] - mean) * rstd * g[c] + b[c], T());
  __syncthreads();
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// multi-head attention of one query row (q, shared) over `rows` key rows
// (row stride C); writes ctx[c] = round_T(sum_j p_hj v_jc)
template <typename T, typename KV>
__device__ void attend(const float* q, const KV* __restrict__ kmat, const KV* __restrict__ vmat,
                       int rows, int C, int H, int smax, float scale,
                       float* sc, float* ctx) {
  const int D = C / H;
  for (int idx = threadIdx.x; idx < rows * H; idx += NT) {
    const int j = idx / H, h = idx % H;
    const KV* kr = kmat + (long long)j * C + h * D;
    const float* qh = q + h * D;
    float s = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = ld4(kr + d);
      s = fmaf(qh[d], kv.x, s);
      s = fmaf(qh[d + 1], kv.y, s);
      s = fmaf(qh[d + 2], kv.z, s);
      s = fmaf(qh[d + 3], kv.w, s);
    }
    sc[h * smax + j] = s * scale;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = warp; h < H; h += NW) {
    float* sh = sc + h * smax;
    float m = -INFINITY;
    for (int j = lane; j < rows; j += 32) m = fmaxf(m, sh[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < rows; j += 32) { const float e = expf(sh[j] - m); sh[j] = e; l += e; }
    l = warp_sum(l);
    for (int j = lane; j < rows; j += 32) sh[j] = rnd(sh[j] / l, T());
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    const float* ph = sc + (c / D) * smax;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < rows; ++j) acc = fmaf(ph[j], ldf(vmat, (long long)j * C + c), acc);
    ctx[c] = rnd(acc, T());
  }
  __syncthreads();
}

// x = round_T(LN(round_T(x + h)))
template <typename T>
__device__ void residual_ln(float* x, const float* h, const float* ln, int C, float eps, float* red) {
  for (int c = threadIdx.x; c < C; c += NT) x[c] = rnd(x[c] + h[c], T());
  __syncthreads();
  layer_norm<T>(x, x, ln, ln + C, C, eps, red);
}

// Philox-4x32-10; returns the first 32-bit word
__device__ __forceinline__ uint32_t philox(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                           uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

template <typename T>
__global__ void __launch_bounds__(NT) ar_decode_kernel(const ArDecodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int C = a.C, H = a.H, I = a.I, V = a.V, N = a.N;
  const int D = C / H;
  const int smax = max(N, a.L);
  const int CP = (C + 3) & ~3, IP = (max(C, I) + 3) & ~3, VP = (V + 3) & ~3;
  float* x = smem;              // hidden state (model-dtype values)
  float* q = x + CP;            // query / temporaries
  float* k = q + CP;
  float* v = k + CP;
  float* h = v + CP;            // attention context, FFN output
  float* t = h + CP;            // FFN hidden (I)
  float* sc = t + IP;           // attention scores (H, smax)
  float* logits = sc + H * smax;
  float* red = logits + VP;     // 80 floats of reduction scratch (f32 + int halves)
  int* redi = reinterpret_cast<int*>(red + 33);
  __shared__ int s_tok;

  const T* emb = static_cast<const T*>(a.emb);
  const T* cross_k = static_cast<const T*>(a.cross_k);
  const T* cross_v = static_cast<const T*>(a.cross_v);
  unsigned char* rep = a.rep + (long long)b * V;
  const int clen = a.cross_len[b];
  const uint32_t key0 = static_cast<uint32_t>(a.seed), key1 = static_cast<uint32_t>(a.seed >> 32);

  // the repetition mask starts with BOS
  for (int i = threadIdx.x; i < V; i += NT) rep[i] = (i == a.bos);
  int tok = a.bos, count = 0;
  bool finished = false;
  __syncthreads();

  int step = 0;
  for (; step < N && !finished; ++step) {
    // ---- embedding (word + type 0, f32) + LayerNorm --------------------
    for (int c = threadIdx.x; c < C; c += NT) x[c] = a.emb_eff[(long long)tok * C + c];
    __syncthreads();
    layer_norm<T>(x, x, a.emb_ln, a.emb_ln + C, C, a.eps, red);

    for (int l = 0; l < a.nl; ++l) {
      const long long wo_cc = (long long)l * C * C, wo_c = (long long)l * C;
      // ---- self-attention: q/k/v, rotary, KV cache ---------------------
      gemv<T>(static_cast<const T*>(a.wq) + wo_cc, static_cast<const T*>(a.bq) + wo_c, nullptr, x, C, C, q);
      gemv<T>(static_cast<const T*>(a.wk) + wo_cc, static_cast<const T*>(a.bk) + wo_c, nullptr, x, C, C, k);
      gemv<T>(static_cast<const T*>(a.wv) + wo_cc, static_cast<const T*>(a.bv) + wo_c, nullptr, x, C, C, v);
      __syncthreads();
      float qn[2], kn[2];
      int nc = 0;
      for (int c = threadIdx.x; c < C; c += NT, ++nc) {
        const int d = c % D;
        const float sn = rnd(a.sin_t[(long long)step * D + d], T());
        const float cs = rnd(a.cos_t[(long long)step * D + d], T());
        const float rq = (c & 1) ? q[c - 1] : -q[c + 1];
        const float rk = (c & 1) ? k[c - 1] : -k[c + 1];
        qn[nc] = rnd(rnd(q[c] * cs, T()) + rnd(rq * sn, T()), T());
        kn[nc] = rnd(rnd(k[c] * cs, T()) + rnd(rk * sn, T()), T());
      }
      __syncthreads();
      float* kc = a.k_cache + ((long long)(l * a.B + b) * N) * C;
      float* vc = a.v_cache + ((long long)(l * a.B + b) * N) * C;
      nc = 0;
      for (int c = threadIdx.x; c < C; c += NT, ++nc) {
        q[c] = qn[nc];
        kc[(long long)step * C + c] = kn[nc];
        vc[(long long)step * C + c] = v[c];
      }
      __syncthreads();
      attend<T, float>(q, kc, vc, step + 1, C, H, smax, a.scale, sc, h);
      gemv<T>(static_cast<const T*>(a.wo) + wo_cc, static_cast<const T*>(a.bo) + wo_c, nullptr, h, C, C, k);
      __syncthreads();
      residual_ln<T>(x, k, a.self_ln + (long long)l * 2 * C, C, a.eps, red);

      // ---- cross-attention over the precomputed encoder K/V -------------
      gemv<T>(static_cast<const T*>(a.cq_w) + wo_cc, static_cast<const T*>(a.cq_b) + wo_c, nullptr, x, C, C, q);
      __syncthreads();
      const long long ckv = ((long long)(l * a.B + b) * a.L) * C;
      attend<T, T>(q, cross_k + ckv, cross_v + ckv, clen, C, H, smax, a.scale, sc, h);
      gemv<T>(static_cast<const T*>(a.co_w) + wo_cc, static_cast<const T*>(a.co_b) + wo_c, nullptr, h, C, C, k);
      __syncthreads();
      residual_ln<T>(x, k, a.cross_ln + (long long)l * 2 * C, C, a.eps, red);

      // ---- FFN (exact GELU) ---------------------------------------------
      gemv<T>(static_cast<const T*>(a.ff_in_w) + (long long)l * I * C,
              static_cast<const T*>(a.ff_in_b) + (long long)l * I, nullptr, x, C, I, t);
      __syncthreads();
      for (int i = threadIdx.x; i < I; i += NT) t[i] = rnd(gelu_exact(t[i]), T());
      __syncthreads();
      gemv<T>(static_cast<const T*>(a.ff_out_w) + (long long)l * C * I,
              static_cast<const T*>(a.ff_out_b) + wo_c, nullptr, t, I, C, h);
      __syncthreads();
      residual_ln<T>(x, h, a.ff_ln + (long long)l * 2 * C, C, a.eps, red);
    }

    // ---- LM head: dense -> GELU -> LN -> tied projection + f32 bias ------
    gemv<T>(static_cast<const T*>(a.ht_w), static_cast<const T*>(a.ht_b), nullptr, x, C, C, h);
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += NT) h[c] = rnd(gelu_exact(h[c]), T());
    __syncthreads();
    layer_norm<T>(h, h, a.head_ln, a.head_ln + C, C, a.eps, red);
    gemv<T>(emb, nullptr, a.head_bias, h, C, V, logits);
    __syncthreads();
    if (a.debug_logits) {
      float* dl = a.debug_logits + ((long long)b * N + step) * V;
      for (int i = threadIdx.x; i < V; i += NT) dl[i] = logits[i];
    }

    // ---- logit processors, in the plain loop's order ---------------------
    if (a.repetition_penalty != 1.f) {
      for (int i = threadIdx.x; i < V; i += NT)
        if (rep[i]) {
          const float z = logits[i];
          logits[i] = z > 0.f ? z / a.repetition_penalty : z * a.repetition_penalty;
        }
    }
    for (int i = threadIdx.x; i < a.ban_until && i < V; i += NT) logits[i] = -INFINITY;
    __syncthreads();
    if (a.use_end_gate) {
      float m = -INFINITY;
      for (int i = threadIdx.x; i < V; i += NT) m = fmaxf(m, logits[i]);
      m = block_max(m, red);
      float s = 0.f;
      for (int i = threadIdx.x; i < V; i += NT) s += expf(logits[i] - m);
      s = block_sum(s, red);
      const float p_eos = expf(logits[a.eos] - m) / s;
      __syncthreads();
      if (p_eos > a.end_gate)
        for (int i = threadIdx.x; i < V; i += NT) logits[i] = (i == a.eos) ? 0.f : -INFINITY;
      __syncthreads();
    }
    if (a.do_sample && a.temperature != 1.f) {
      for (int i = threadIdx.x; i < V; i += NT) logits[i] = logits[i] / a.temperature;
      __syncthreads();
    }
    if (a.do_sample && a.top_k > 0) {
      // k rounds of (max over the values below the previous max): the
      // descending top-k values, exact ties collapsing into one slot
      float vals[MAX_TOP_K];
      const int kk = min(a.top_k, V);
      float prev = INFINITY;
      for (int r = 0; r < kk; ++r) {
        float m = -INFINITY;
        for (int i = threadIdx.x; i < V; i += NT) {
          const float z = logits[i];
          if (z < prev) m = fmaxf(m, z);
        }
        prev = block_max(m, red);
        vals[r] = prev;
      }
      float cut = vals[kk - 1];
      if (a.top_p < 1.f) {
        // fused nucleus cutoff over the k ordered values
        float total = 0.f;
        for (int r = 0; r < kk; ++r) total += expf(vals[r] - vals[0]);
        float cum = 0.f, thresh = INFINITY;
        for (int r = 0; r < kk; ++r) {
          const float p = expf(vals[r] - vals[0]) / total;
          cum += p;
          if (!(cum - p > a.top_p)) thresh = fminf(thresh, vals[r]);
        }
        cut = fmaxf(thresh, cut);
      }
      for (int i = threadIdx.x; i < V; i += NT)
        if (logits[i] < cut) logits[i] = -INFINITY;
      __syncthreads();
    }

    // ---- sample (Gumbel-max) or greedy argmax ---------------------------
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int i = threadIdx.x; i < V; i += NT) {
      float y = logits[i];
      if (a.do_sample) {
        const uint32_t bits = philox(static_cast<uint32_t>(i), static_cast<uint32_t>(step),
                                     static_cast<uint32_t>(b), 0u, key0, key1);
        const float u = (static_cast<float>(bits >> 8) + 0.5f) * (1.f / 16777216.f);
        y += -logf(-logf(u));
      }
      argmax_merge(best, best_i, y, i);
    }
    const int nt = block_argmax(best, best_i, red, redi);
    if (threadIdx.x == 0) {
      a.tokens[(long long)b * N + step] = nt;
      rep[nt] = 1;
      s_tok = nt;
    }
    __syncthreads();
    tok = s_tok;
    ++count;
    finished = (tok == a.eos);
  }

  // PAD after EOS; lengths count the EOS
  for (int i = step + threadIdx.x; i < N; i += NT) a.tokens[(long long)b * N + i] = a.pad;
  if (threadIdx.x == 0) a.lengths[b] = count;
}

template <typename T>
int launch(const ArDecodeArgs* args, void* stream) {
  const ArDecodeArgs& a = *args;
  // C <= 2 * NT: the rotary step keeps two channels per thread in registers;
  // D % 4 == 0: attention scores read keys four at a time
  if (a.top_k > MAX_TOP_K || a.C % 8 != 0 || a.I % 8 != 0 || a.C > 2 * NT || a.H <= 0 ||
      a.C % a.H != 0 || (a.C / a.H) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int CP = (a.C + 3) & ~3, IP = ((a.C > a.I ? a.C : a.I) + 3) & ~3, VP = (a.V + 3) & ~3;
  const int smax = a.N > a.L ? a.N : a.L;
  const size_t smem = sizeof(float) * (5 * CP + IP + (size_t)a.H * smax + VP + 80);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ar_decode_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ar_decode_kernel<T><<<a.B, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ar_decode_bf16(const ArDecodeArgs* args, void* stream) {
  return launch<__nv_bfloat16>(args, stream);
}

extern "C" int ar_decode_f32(const ArDecodeArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int ar_decode_args_size() { return static_cast<int>(sizeof(ArDecodeArgs)); }
