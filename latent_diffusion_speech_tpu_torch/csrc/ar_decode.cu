// K1: the whole RoFormer autoregressive decode in one kernel launch.
//
// Replaces: latent_diffusion_speech_tpu/ops/pallas/ar_decode.py, function
// `roformer_decode_pallas` (body `_decode_kernel`).
//
// What bounds it on this card: a decode step is a chain of matrix-vector
// products (per stream ~1.8 M multiply-adds at the flagship width, C=256,
// I=512, V=4099) whose weights (~3.5 MB in bf16, 2.1 MB of it the tied LM
// head) are read once per step and per stream, and the steps depend on
// each other.  One SM pulls those bytes from L2 at one SM's rate (~115 µs a
// step); the plain loop, ~40 launches a step, is bound by launch overhead.
//
// Design: one thread-block cluster of CL blocks per stream (grid = B x CL;
// a block is 256 computing threads and one warp that issues weight
// copies), the loop over the N steps inside the kernel, so a whole
// generation is one launch and each step's weight read is spread over CL
// SMs.  Block `r` of a cluster owns heads [r nh, (r+1) nh) (nh = H / CL):
// their q/k/v and cross q rows, the rotary step, their slice of the KV
// cache and both attentions for them; and a 1/CL row slice of every other
// product (wo, co, ff_in, ff_out, the head transform), V/CL rows of the
// tied head with the matching logits and repetition mask.
//
// Weights stream through a ring of shared-memory slots filled by bulk
// asynchronous copies (the TMA engine) in the fixed order the step reads
// them, run ahead by the copy warp (see `Ring`), so the products read
// shared memory.  After each phase that makes part of a vector, every
// block pushes its slice into each peer's shared memory (st.async, which
// completes on the receiver's mbarrier) and waits for its peers' slices;
// no cluster-wide barrier sits in the loop.  The embedding, the LayerNorms
// and the GELUs run on the whole vector in every block.  Reductions over
// the vocabulary are exchanged and merged identically in every block: the
// end gate's (max, sum of exp), the descending top-k values of each slice
// (exact ties collapsing into one slot), and the (value, index) argmax
// pair, ties to the lowest index; so every block picks the same token and
// leaves the loop on the same step, and the kernel ends on a cluster
// barrier.
//
// Attention runs over cache rows in parallel: one thread a row for the
// scores, the softmax's max and sum from the warps' partial results, and
// p v by each warp over its own rows, the warps' sums added in order.  The
// LayerNorms add the warps' partial sums in order; the top-k merges the
// warps' lists, then the blocks'.  Each computing thread owns the same
// elements of a vector in every stage, so only reductions need barriers,
// and work that every warp repeats stays small (more warps made it cost
// more: 8 computing warps measured faster than 16 or 4).  The KV cache holds
// the model dtype (a bf16 model rounds k and v to bf16 before caching them, so
// this is exact) in shared memory when it fits (`kv_smem`, decided by the
// wrapper's plan), else in device memory; the code reads it through generic
// pointers either way.  Matrix products accumulate in f32 and round to the
// model dtype; LayerNorm, softmax and the logit processors run in f32, in
// the plain loop's order (repetition penalty -> ban -> end gate ->
// temperature -> fused top-k/top-p).  Sampling is Gumbel-max with
// Philox-4x32-10 noise keyed by (seed, stream, step, vocab index), the same
// noise for any CL.  A stream stops at its EOS and fills the rest with PAD.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
  const void* wqkv;        // (nl, 3, C, C) T: query, key, value
  const void* bqkv;        // (nl, 3, C) T
  const void* wo; const void* bo;                                  // (nl, C, C), (nl, C)
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
  void* kv_cache;          // (B, CL, 2, nl, nh, N, D) T scratch when !kv_smem, else null
  const long long* seed;   // (1,) Philox key
  int* tokens;             // (B, N) out
  int* lengths;            // (B,) out
  float* debug_logits;     // (B, N, V) raw logits per step, or null
  int B, C, H, I, V, L, N, nl;
  int do_sample, top_k, use_end_gate, eos, pad, bos, ban_until;
  int CL, nh, Vs, kv_smem, ckv_smem, stages, chunk, smem_bytes;  // the wrapper's plan (checked here)
  float eps, scale, temperature, top_p, repetition_penalty, end_gate;
};
static_assert(sizeof(ArDecodeArgs) == 376, "ArDecodeArgs must match the wrapper's _Args");
// each field where the wrapper's ctypes `_Args` puts it
// (tests/test_torch_lm.py holds these offsets to `_Args`)
#define ARG_AT(field, offset) \
  static_assert(offsetof(ArDecodeArgs, field) == (offset), "ArDecodeArgs." #field " must sit where _Args has it")
ARG_AT(emb_eff, 0);
ARG_AT(emb, 8);
ARG_AT(head_bias, 16);
ARG_AT(sin_t, 24);
ARG_AT(cos_t, 32);
ARG_AT(emb_ln, 40);
ARG_AT(ht_w, 48);
ARG_AT(ht_b, 56);
ARG_AT(head_ln, 64);
ARG_AT(wqkv, 72);
ARG_AT(bqkv, 80);
ARG_AT(wo, 88);
ARG_AT(bo, 96);
ARG_AT(self_ln, 104);
ARG_AT(cq_w, 112);
ARG_AT(cq_b, 120);
ARG_AT(co_w, 128);
ARG_AT(co_b, 136);
ARG_AT(cross_ln, 144);
ARG_AT(ff_in_w, 152);
ARG_AT(ff_in_b, 160);
ARG_AT(ff_out_w, 168);
ARG_AT(ff_out_b, 176);
ARG_AT(ff_ln, 184);
ARG_AT(cross_k, 192);
ARG_AT(cross_v, 200);
ARG_AT(cross_len, 208);
ARG_AT(kv_cache, 216);
ARG_AT(seed, 224);
ARG_AT(tokens, 232);
ARG_AT(lengths, 240);
ARG_AT(debug_logits, 248);
ARG_AT(B, 256);
ARG_AT(C, 260);
ARG_AT(H, 264);
ARG_AT(I, 268);
ARG_AT(V, 272);
ARG_AT(L, 276);
ARG_AT(N, 280);
ARG_AT(nl, 284);
ARG_AT(do_sample, 288);
ARG_AT(top_k, 292);
ARG_AT(use_end_gate, 296);
ARG_AT(eos, 300);
ARG_AT(pad, 304);
ARG_AT(bos, 308);
ARG_AT(ban_until, 312);
ARG_AT(CL, 316);
ARG_AT(nh, 320);
ARG_AT(Vs, 324);
ARG_AT(kv_smem, 328);
ARG_AT(ckv_smem, 332);
ARG_AT(stages, 336);
ARG_AT(chunk, 340);
ARG_AT(smem_bytes, 344);
ARG_AT(eps, 348);
ARG_AT(scale, 352);
ARG_AT(temperature, 356);
ARG_AT(top_p, 360);
ARG_AT(repetition_penalty, 364);
ARG_AT(end_gate, 368);
#undef ARG_AT

namespace {

constexpr int NT = 256;        // computing threads per block; one more warp issues the weight copies
constexpr int PER = (1024 + NT - 1) / NT;  // elements of a C <= 1024 vector a thread owns
constexpr int NW = NT / 32;    // computing warps per block
constexpr int MAX_TOP_K = 64;
constexpr int RED = 112;       // floats of reduction scratch: f32 [0, 2 NW), int [40, 40 + NW), a flag at 100
constexpr int TASK_BYTES = 32;  // sizeof(Task)

// barrier of the NT computing threads (the copy warp never joins it)
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory"); }

__device__ __forceinline__ float rnd(float x, float) { return x; }
__device__ __forceinline__ float rnd(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float ldf(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// argmax over (value, index) pairs, ties to the lowest index
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
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

// 4 consecutive elements as f32 (8- or 16-byte load, generic address)
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__host__ __device__ constexpr long long pad4(long long n) { return (n + 3) & ~3LL; }
__host__ __device__ constexpr long long pad16(long long n) { return (n + 15) & ~15LL; }

// ---- the weight ring ---------------------------------------------------
// Every matrix-vector product of a step reads a contiguous run of weight
// rows (this block's slice).  The step's products are tasks in a fixed
// order; each task's rows are cut into chunks of at most `chunk` bytes, and
// a ring of S slots in shared memory is fed by bulk asynchronous copies
// (cp.async.bulk, the TMA engine), each completing on its slot's `full`
// mbarrier.  One extra warp (the copy warp) issues chunk g + S as soon as
// every computing warp has arrived on the slot's `empty` mbarrier after
// chunk g.  The order is the same every step, so the copies run ahead
// through the attention, the exchanges and the sampling, and into the next
// step; computing warps never wait for each other between chunks.
struct Task {
  const char* base;  // the first row of the slice
  int rows;          // rows of the slice
  int row_bytes;     // in x sizeof(T)
  int rpc;           // rows a chunk
  int pad[3];
};
static_assert(sizeof(Task) == TASK_BYTES, "Task size");

struct Ring {
  const Task* tasks;
  int ntasks, S, chunk;
  char* slots;      // S x chunk bytes
  uint64_t* full;   // S mbarriers: the slot's chunk has landed
  uint64_t* empty;  // S mbarriers: every computing warp is done with the slot
  // computing threads: the next chunk's slot and its parity, the next task
  int slot, parity, task;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(const uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bar_arrive(const uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// The copy warp's lane 0: chunks in task order, forever, until *stop is set
// (read after each wait for a free slot).
__device__ void ring_produce(const Ring& r, const volatile int* stop) {
  int slot = 0, parity = 0, task = 0, k = 0;
  bool wrapped = false;
  for (;;) {
    if (wrapped) bar_wait(r.empty + slot, parity);
    if (*stop) return;
    for (;;) {  // skip tasks without rows
      const Task& tk = r.tasks[task];
      if (k * tk.rpc < tk.rows) break;
      k = 0;
      task = task + 1 == r.ntasks ? 0 : task + 1;
    }
    const Task& tk = r.tasks[task];
    const int rows = min(tk.rpc, tk.rows - k * tk.rpc);
    const uint32_t bytes = static_cast<uint32_t>(rows * tk.row_bytes);
    const uint32_t bar = smem_addr(r.full + slot);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem_addr(r.slots + (long long)slot * r.chunk)),
        "l"(tk.base + (long long)k * tk.rpc * tk.row_bytes), "r"(bytes), "r"(bar)
        : "memory");
    ++k;
    if (++slot == r.S) {
      slot = 0;
      if (wrapped) parity ^= 1;
      wrapped = true;
    }
  }
}

__device__ __forceinline__ void ring_next(Ring& r) {
  if (++r.slot == r.S) { r.slot = 0; r.parity ^= 1; }
}

// Sum each of the R rows' partial sums over the warp: at each of the first
// log2(R) butterfly levels a lane keeps half of its rows and adds its
// partner's half of the other rows (R - 1 shuffles in all, not R x 5); the
// last levels add single values.  Lanes with lane % (32 / R) == 0 end with
// the full sum of row `return value` in acc[0].
template <int R>
__device__ __forceinline__ int reduce_rows(float (&acc)[R], int lane) {
  int row = 0;
#pragma unroll
  for (int n = R / 2, bit = 16; n >= 1; n /= 2, bit /= 2) {
    const bool up = lane & bit;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? acc[i] : acc[i + n];
      const float keep = up ? acc[i + n] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
    if (up) row += n;
  }
#pragma unroll
  for (int bit = 16 / R; bit >= 1; bit /= 2) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], bit);
  return row;
}

// y[o] = round_T(sum_i x[i] W_o[i] + bias[o]) (+ post[o] in f32 after the
// rounding, for the LM head's f32 bias) for the `ntask` consecutive tasks
// of the ring starting at the next chunk, rows numbered across the tasks;
// bias, post, x and y in shared memory.  Per chunk: wait for its slot, one
// warp per R rows (16-byte slices of a row per lane, lane-strided), the
// rows summed by `reduce_rows`, and each warp's arrival on the slot's
// `empty` barrier; one barrier of the computing threads at the end.
template <typename T, int R = 4>
__device__ void gemv(Ring& r, int ntask, const float* bias, const float* post, const float* x, float* y) {
  constexpr int VN = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int o_base = 0;
  for (int tt = 0; tt < ntask; ++tt) {
    const int t = r.task;
    r.task = t + 1 == r.ntasks ? 0 : t + 1;
    const int rows_all = r.tasks[t].rows, rpc = r.tasks[t].rpc, in = r.tasks[t].row_bytes / sizeof(T);
    for (int k = 0; k * rpc < rows_all; ++k) {
      const int rows = min(rpc, rows_all - k * rpc);
      bar_wait(r.full + r.slot, r.parity);
      const T* W = reinterpret_cast<const T*>(r.slots + (long long)r.slot * r.chunk);
      for (int o0 = warp * R; o0 < rows; o0 += NW * R) {
        float acc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = 0.f;
        for (int i = lane * VN; i < in; i += 32 * VN) {
          uint4 w[R];
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
            w[rr] = o0 + rr < rows ? *reinterpret_cast<const uint4*>(W + (long long)(o0 + rr) * in + i)
                                   : make_uint4(0u, 0u, 0u, 0u);
          float xv[VN];
#pragma unroll
          for (int e = 0; e < VN; e += 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(x + i + e);
            xv[e] = t4.x; xv[e + 1] = t4.y; xv[e + 2] = t4.z; xv[e + 3] = t4.w;
          }
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            float wf[VN];
            unpack(w[rr], wf);
#pragma unroll
            for (int e = 0; e < VN; ++e) acc[rr] = fmaf(xv[e], wf[e], acc[rr]);
          }
        }
        const int o = o0 + reduce_rows<R>(acc, lane);
        if ((lane & (32 / R - 1)) == 0 && o < rows) {
          const int oo = o_base + k * rpc + o;
          float v = rnd(acc[0] + (bias ? bias[oo] : 0.f), T());
          if (post) v += post[oo];
          y[oo] = v;
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(r.empty + r.slot);  // this warp is done with the slot
      ring_next(r);
    }
    o_base += rows_all;
  }
  csync();
}

// x = round_T(LN(src)) with src = x, or src = round_T(x + h) when h is given
// (the residual); x, h, g, b in shared memory.  Thread c owns elements c,
// c + NT, ...: the mean and then the variance from the warps' partial sums
// (wred, 2 NW floats), added in warp order by every thread.
template <typename T>
__device__ void layer_norm(float* x, const float* h, const float* g, const float* b, int C, float eps,
                           float* wred) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v[PER] = {};
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {  // fixed indices keep v in registers
    const int c = threadIdx.x + k * NT;
    if (c < C) {
      v[k] = h ? rnd(x[c] + h[c], T()) : x[c];
      s += v[k];
    }
  }
  s = warp_sum(s);
  if (lane == 0) wred[warp] = s;
  csync();
  s = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += wred[w];
  const float mean = s / C;
  float s2 = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (threadIdx.x + k * NT < C) s2 += (v[k] - mean) * (v[k] - mean);
  s2 = warp_sum(s2);
  if (lane == 0) wred[NW + warp] = s2;
  csync();
  s2 = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s2 += wred[NW + w];
  const float rstd = rsqrtf(s2 / C + eps);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = threadIdx.x + k * NT;
    if (c < C) x[c] = rnd((v[k] - mean) * rstd * g[c] + b[c], T());
  }
  csync();
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// attention of one query head q (D values, shared) over `rows` key rows
// (row stride ks, shared or device memory); ctx[d] = round_T(sum_j p_j
// v_jd), p = round_T(softmax).  Thread j % NT scores row j; the block's max
// and sum are the NW warps' partial results added in warp order; warp w
// then takes rows [w rpw, (w+1) rpw), its lanes split over (row group,
// 4 channels); the row groups are added by shuffles, the warps in order.
// sc: >= rows floats; part: NW x D floats; wred: 2 NW floats.
template <typename T>
__device__ void attend(const float* q, const T* kmat, const T* vmat, long long ks, int rows, int D,
                       float scale, float* sc, float* part, float* wred, float* ctx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < rows; j += NT) {
    const T* kr = kmat + j * ks;
    float s = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = ld4(kr + d);
      s = fmaf(q[d], kv.x, s);
      s = fmaf(q[d + 1], kv.y, s);
      s = fmaf(q[d + 2], kv.z, s);
      s = fmaf(q[d + 3], kv.w, s);
    }
    s *= scale;
    sc[j] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  if (lane == 0) wred[warp] = m;
  csync();
  m = wred[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = fmaxf(m, wred[w]);
  float l = 0.f;
  for (int j = threadIdx.x; j < rows; j += NT) { const float e = expf(sc[j] - m); sc[j] = e; l += e; }
  l = warp_sum(l);
  if (lane == 0) wred[NW + warp] = l;
  csync();
  l = wred[NW];
#pragma unroll
  for (int w = 1; w < NW; ++w) l += wred[NW + w];
  const int Q4 = D / 4, RG = Q4 >= 32 ? 1 : 32 / Q4;  // channel quads; row groups a warp
  const int rpw = (rows + NW - 1) / NW, j0 = warp * rpw, j1 = min(rows, j0 + rpw);
  for (int u0 = 0; u0 < (Q4 >= 32 ? Q4 : 32); u0 += 32) {
    const int u = u0 + lane;
    const int rg = Q4 >= 32 ? 0 : u / Q4, cq = Q4 >= 32 ? u : u % Q4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rg < RG && cq < Q4)
      for (int j = j0 + rg; j < j1; j += RG) {
        const float p = rnd(sc[j] / l, T());
        const float4 v4 = ld4(vmat + j * ks + 4 * cq);
        acc.x = fmaf(p, v4.x, acc.x);
        acc.y = fmaf(p, v4.y, acc.y);
        acc.z = fmaf(p, v4.z, acc.z);
        acc.w = fmaf(p, v4.w, acc.w);
      }
    // add the row groups: lane cq ends with the sum over lanes cq + i Q4
    for (int off = Q4; off < 32; off *= 2) {
      float4 o;
      o.x = __shfl_down_sync(0xffffffffu, acc.x, off);
      o.y = __shfl_down_sync(0xffffffffu, acc.y, off);
      o.z = __shfl_down_sync(0xffffffffu, acc.z, off);
      o.w = __shfl_down_sync(0xffffffffu, acc.w, off);
      if (lane + off < 32) { acc.x += o.x; acc.y += o.y; acc.z += o.z; acc.w += o.w; }
    }
    if (rg == 0 && cq < Q4) *reinterpret_cast<float4*>(part + warp * D + 4 * cq) = acc;
  }
  csync();
  for (int d = threadIdx.x; d < D; d += NT) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) acc += part[w * D + d];
    ctx[d] = rnd(acc, T());
  }
  csync();
}

// ---- exchanges between the blocks of a cluster -------------------------
// A block pushes values into its peers' shared memory with st.async, each
// store completing its bytes on the receiving block's mbarrier for that
// buffer; the receiver has armed the barrier with the bytes it expects and
// waits on it.  No cluster-wide barrier (whose release / acquire costs a
// device-scope fence and an L1 invalidation each time) sits in the loop.
// A block can only be one exchange ahead of a peer (each exchange needs
// every peer's data of the one before), and consecutive exchanges of a
// vector alternate between two buffers, so a buffer is rewritten only
// after its receiver has read it.
struct Xchg {
  uint64_t* bar;  // this block's mbarrier for the buffer
  int parity;     // the parity of its next phase
};

__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// one 4-byte value into block `rank`'s copy of `dst`, signalling its copy of `bar`
__device__ __forceinline__ void push(const float* dst, float v, const uint64_t* bar, int rank) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   mapa(smem_addr(dst), rank)),
               "r"(__float_as_uint(v)), "r"(mapa(smem_addr(bar), rank))
               : "memory");
}

// thread 0: this block expects `bytes` on the buffer before its next phase completes
__device__ __forceinline__ void expect(const Xchg& x, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(x.bar)), "r"(bytes)
               : "memory");
}

// every thread: wait for the buffer's phase (its bytes from every sender)
__device__ void receive(Xchg& x) {
  const uint32_t bar = smem_addr(x.bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(x.parity)
        : "memory");
  }
  x.parity ^= 1;
}

// Every block of the cluster gets buf[off, off + n) of this block (its own
// slice, written before the call): the slice goes into the same place of
// each peer's `buf`, and this block waits for every peer's slice.
__device__ void share(Xchg& x, float* buf, int off, int n, int CL, int me) {
  if (threadIdx.x == 0) expect(x, static_cast<uint32_t>((CL - 1) * n * 4));
  csync();
  for (int e = threadIdx.x; e < n * (CL - 1); e += NT) {
    const int r = e / n, i = off + e % n;
    push(buf + i, buf[i], x.bar, r < me ? r : r + 1);
  }
  receive(x);
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

// A block's dynamic shared memory, as byte offsets.  The wrapper's `plan`
// computes the same total (`_smem_bytes`).
struct Layout {
  long long x, xa, xb, q, sc, part, wk, logits, rep, xchg, red, lnp, bias, hbias;  // f32 buffers
  long long tasks, bars, ring, kv, ckv, total;
};

__host__ __device__ inline Layout layout(const ArDecodeArgs& a, int elem) {
  const int nh = a.nh, D = a.C / a.H, hd = nh * D, Cs = a.C / a.CL, Is = a.I / a.CL;
  const int X = a.C > a.I ? a.C : a.I, smax = a.N > a.L ? a.N : a.L;
  Layout o;
  long long f = 0;  // floats so far
  o.x = f; f += pad4(a.C);
  o.xa = f; f += pad4(X);
  o.xb = f; f += pad4(X);
  o.q = f; f += 3 * pad4(hd);
  o.sc = f; f += pad4(smax);
  o.part = f; f += (long long)NW * D;
  o.wk = f; f += NW * MAX_TOP_K;
  o.logits = f; f += pad4(a.Vs);
  o.rep = f; f += pad4((a.Vs + 3) / 4);
  o.xchg = f; f += pad4(a.CL * (4 + MAX_TOP_K + 2));
  o.red = f; f += RED;
  o.lnp = f; f += (2 + 3LL * a.nl) * 2 * a.C;
  o.bias = f; f += pad4((long long)a.nl * (4 * hd + 3 * Cs + Is) + Cs);
  o.hbias = f; f += pad4(a.Vs);
  long long at = 4 * f;  // bytes
  o.tasks = at; at += (8LL * a.nl + 2) * TASK_BYTES;
  o.bars = at; at += pad16(8LL * (2 * a.stages + 5));
  o.ring = at; at += (long long)a.stages * a.chunk;
  o.kv = at; if (a.kv_smem) at += pad16(2LL * a.nl * nh * a.N * D * elem);
  o.ckv = at; if (a.ckv_smem) at += pad16(2LL * a.nl * a.L * hd * elem);
  o.total = at;
  return o;
}

template <typename T>
__global__ void __launch_bounds__(NT + 32, 1) ar_decode_kernel(const ArDecodeArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), CL = a.CL;
  const int b = blockIdx.x / CL;
  const int C = a.C, I = a.I, V = a.V, N = a.N, nh = a.nh, nl = a.nl;
  const int D = C / a.H, hd = nh * D, h0 = rank * nh;
  const int Cs = C / CL, c0 = rank * Cs, Is = I / CL, i0 = rank * Is;
  const int v0 = rank * a.Vs, nv = max(0, min(a.Vs, V - v0));
  const Layout lay = layout(a, sizeof(T));
  float* sm = reinterpret_cast<float*>(smem);
  float* x = sm + lay.x;            // hidden state (model-dtype values)
  float* xa = sm + lay.xa;          // exchange buffers, (max(C, I),) each
  float* xb = sm + lay.xb;
  float* q = sm + lay.q;            // this block's heads: q, k, v (hd each)
  float* k = q + pad4(hd);
  float* v = k + pad4(hd);
  float* sc = sm + lay.sc;          // attention scores
  float* part = sm + lay.part;      // p v partial sums
  float* wk = sm + lay.wk;          // (NW, MAX_TOP_K): each warp's descending top-k values
  float* logits = sm + lay.logits;  // this block's vocabulary slice (Vs)
  unsigned char* rep = reinterpret_cast<unsigned char*>(sm + lay.rep);  // token already generated
  float* gate_x = sm + lay.xchg;    // (CL, 4): end-gate max, sum, eos logit
  float* topk_x = gate_x + 4 * CL;  // (CL, MAX_TOP_K): each block's descending top-k values
  float* best_x = topk_x + MAX_TOP_K * CL;  // (CL, 2): each block's argmax value and index
  float* red = sm + lay.red;        // reduction scratch
  int* redi = reinterpret_cast<int*>(red + 40);
  float* lnp = sm + lay.lnp;        // LayerNorm (scale, bias): emb, head, then (self, cross, ff) a layer
  float* bias = sm + lay.bias;      // this block's bias rows, in gemv order
  float* hbias = sm + lay.hbias;    // this block's slice of the LM head's f32 bias
  Task* tasks = reinterpret_cast<Task*>(smem + lay.tasks);
  T* kv_base = a.kv_smem ? reinterpret_cast<T*>(smem + lay.kv)
                         : static_cast<T*>(a.kv_cache) + ((long long)b * CL + rank) * 2 * nl * nh * N * D;
  const long long kv_half = (long long)nl * nh * N * D;  // k rows, then v rows

  const T* emb = static_cast<const T*>(a.emb);
  const int clen = a.cross_len[b];
  const unsigned long long seed = static_cast<unsigned long long>(a.seed[0]);
  const uint32_t key0 = static_cast<uint32_t>(seed), key1 = static_cast<uint32_t>(seed >> 32);

  // ---- set-up (computing threads): parameters into shared memory, the
  // task list, the barriers ---------------------------------------------
  const int E = sizeof(T);
  volatile int* stop = reinterpret_cast<volatile int*>(red + 100);  // tells the copy warp to finish
  T* ckv_s = reinterpret_cast<T*>(smem + lay.ckv);
  Ring ring;
  ring.tasks = tasks;
  ring.ntasks = 8 * nl + 2;
  ring.slots = reinterpret_cast<char*>(smem + lay.ring);
  ring.full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  ring.empty = ring.full + a.stages;
  ring.S = a.stages;
  ring.chunk = a.chunk;
  ring.slot = ring.parity = ring.task = 0;
  const int ct = threadIdx.x < NT ? threadIdx.x : 0x7fffffff;  // the copy warp copies nothing
  auto copy_f = [&](float* dst, const float* src, int n) {
    for (int i = ct; i < n; i += NT) dst[i] = src[i];
  };
  auto copy_t = [&](float* dst, const void* src, long long off, int n) {
    for (int i = ct; i < n; i += NT) dst[i] = ldf(static_cast<const T*>(src), off + i);
  };
  copy_f(lnp, a.emb_ln, 2 * C);
  copy_f(lnp + 2 * C, a.head_ln, 2 * C);
  float* bp = bias;
  for (int l = 0; l < nl; ++l) {
    const long long lc = (long long)l * C;
    copy_f(lnp + (2 + 3 * l) * 2 * C, a.self_ln + 2 * lc, 2 * C);
    copy_f(lnp + (3 + 3 * l) * 2 * C, a.cross_ln + 2 * lc, 2 * C);
    copy_f(lnp + (4 + 3 * l) * 2 * C, a.ff_ln + 2 * lc, 2 * C);
    for (int m = 0; m < 3; ++m, bp += hd) copy_t(bp, a.bqkv, (long long)(3 * l + m) * C + h0 * D, hd);
    copy_t(bp, a.bo, lc + c0, Cs); bp += Cs;
    copy_t(bp, a.cq_b, lc + h0 * D, hd); bp += hd;
    copy_t(bp, a.co_b, lc + c0, Cs); bp += Cs;
    copy_t(bp, a.ff_in_b, (long long)l * I + i0, Is); bp += Is;
    copy_t(bp, a.ff_out_b, lc + c0, Cs); bp += Cs;
  }
  copy_t(bp, a.ht_b, c0, Cs);
  copy_f(hbias, a.head_bias + v0, nv);
  for (int i = ct; i < nv; i += NT) rep[i] = (v0 + i == a.bos);  // the mask starts with BOS
  // this block's cross keys and values of layer l, row stride cks
  const long long cks = a.ckv_smem ? hd : C;
  auto ckv_v = [&](int l) -> const T* {
    return a.ckv_smem ? ckv_s + (long long)(2 * l + 1) * a.L * hd
                      : static_cast<const T*>(a.cross_v) + ((long long)(l * a.B + b) * a.L) * C + h0 * D;
  };
  auto ckv_k = [&](int l) -> const T* {
    return a.ckv_smem ? ckv_s + (long long)(2 * l) * a.L * hd
                      : static_cast<const T*>(a.cross_k) + ((long long)(l * a.B + b) * a.L) * C + h0 * D;
  };
  if (threadIdx.x < NT && a.ckv_smem) {
    // this block's heads of the encoder K/V (the valid rows), row stride hd
    T* dst = reinterpret_cast<T*>(smem + lay.ckv);
    for (int l = 0; l < nl; ++l) {
      const long long src = ((long long)(l * a.B + b) * a.L) * C + h0 * D;
      T* dk = dst + (long long)(2 * l) * a.L * hd;
      T* dv = dk + (long long)a.L * hd;
      for (int e = threadIdx.x; e < clen * hd; e += NT) {
        const int j = e / hd, c = e % hd;
        dk[e] = static_cast<const T*>(a.cross_k)[src + (long long)j * C + c];
        dv[e] = static_cast<const T*>(a.cross_v)[src + (long long)j * C + c];
      }
    }
  }

  if (threadIdx.x == 0) {
    *stop = 0;
    int t = 0;
    auto add = [&](const void* w, long long row0, int rows, int in) {
      Task& tk = tasks[t++];
      tk.row_bytes = in * E;
      tk.base = static_cast<const char*>(w) + row0 * tk.row_bytes;
      tk.rows = rows;
      tk.rpc = a.chunk / tk.row_bytes;
    };
    for (int l = 0; l < nl; ++l) {
      for (int m = 0; m < 3; ++m) add(a.wqkv, (long long)(3 * l + m) * C + h0 * D, hd, C);
      add(a.wo, (long long)l * C + c0, Cs, C);
      add(a.cq_w, (long long)l * C + h0 * D, hd, C);
      add(a.co_w, (long long)l * C + c0, Cs, C);
      add(a.ff_in_w, (long long)l * I + i0, Is, C);
      add(a.ff_out_w, (long long)l * C + c0, Cs, I);
    }
    add(a.ht_w, c0, Cs, C);
    add(a.emb, v0, nv, C);
    // full: one arrival (the copy warp's); empty: one a computing warp; the
    // exchange buffers': one (this block's thread 0)
    for (int s = 0; s < 2 * ring.S + 5; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(ring.full + s)),
                   "r"(s >= ring.S && s < 2 * ring.S ? NW : 1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster.sync();  // every peer runs, its barriers initialised, before anything reaches it
  if (threadIdx.x >= NT) {  // the copy warp
    if (threadIdx.x == NT) ring_produce(ring, stop);
    __syncwarp();
    cluster.sync();
    return;
  }
  uint64_t* xbar = ring.full + 2 * ring.S;
  Xchg xa_x{xbar, 0}, xb_x{xbar + 1, 0}, gate_xc{xbar + 2, 0}, topk_xc{xbar + 3, 0}, best_xc{xbar + 4, 0};
  int tok = a.bos, count = 0;
  bool finished = false;

  int step = 0;
  for (; step < N && !finished; ++step) {
    // ---- embedding (word + type 0, f32) + LayerNorm, whole vector --------
    for (int c = threadIdx.x; c < C; c += NT) x[c] = a.emb_eff[(long long)tok * C + c];
    csync();
    layer_norm<T>(x, nullptr, lnp, lnp + C, C, a.eps, red);

    bp = bias;
    for (int l = 0; l < nl; ++l) {
      const float* ln = lnp + (2 + 3 * l) * 2 * C;
      // ---- self-attention of this block's heads: q/k/v, rotary, cache ---
      float sn[PER], cs[PER];
#pragma unroll
      for (int n = 0; n < PER; ++n) {  // loads in flight during the products
        const int c = threadIdx.x + n * NT;
        if (c < hd) {
          sn[n] = rnd(a.sin_t[(long long)step * D + c % D], T());
          cs[n] = rnd(a.cos_t[(long long)step * D + c % D], T());
        }
      }
      gemv<T>(ring, 3, bp, nullptr, x, q);  // q, k, v: hd rows each, contiguous in shared memory
      bp += 3 * hd;
      float qn[PER], kn[PER];
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int c = threadIdx.x + n * NT;
        if (c < hd) {
          const float rq = (c & 1) ? q[c - 1] : -q[c + 1];
          const float rk = (c & 1) ? k[c - 1] : -k[c + 1];
          qn[n] = rnd(rnd(q[c] * cs[n], T()) + rnd(rq * sn[n], T()), T());
          kn[n] = rnd(rnd(k[c] * cs[n], T()) + rnd(rk * sn[n], T()), T());
        }
      }
      csync();
      T* kc = kv_base + (long long)l * nh * N * D;
      T* vc = kc + kv_half;
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int c = threadIdx.x + n * NT;
        if (c < hd) {
          const long long at = ((long long)(c / D) * N + step) * D + c % D;
          q[c] = qn[n];
          stf(kc + at, kn[n]);
          stf(vc + at, v[c]);
        }
      }
      csync();
      for (int hh = 0; hh < nh; ++hh)
        attend<T>(q + hh * D, kc + (long long)hh * N * D, vc + (long long)hh * N * D, D, step + 1, D,
                  a.scale, sc, part, red, xa + (h0 + hh) * D);
      share(xa_x, xa, h0 * D, hd, CL, rank);
      gemv<T>(ring, 1, bp, nullptr, xa, xb + c0);
      bp += Cs;
      share(xb_x, xb, c0, Cs, CL, rank);
      layer_norm<T>(x, xb, ln, ln + C, C, a.eps, red);

      // ---- cross-attention of this block's heads over the encoder K/V ----
      gemv<T>(ring, 1, bp, nullptr, x, q);
      bp += hd;
      for (int hh = 0; hh < nh; ++hh)
        attend<T>(q + hh * D, ckv_k(l) + hh * D, ckv_v(l) + hh * D, cks, clen, D, a.scale, sc, part, red,
                  xa + (h0 + hh) * D);
      share(xa_x, xa, h0 * D, hd, CL, rank);
      gemv<T>(ring, 1, bp, nullptr, xa, xb + c0);
      bp += Cs;
      share(xb_x, xb, c0, Cs, CL, rank);
      layer_norm<T>(x, xb, ln + 2 * C, ln + 3 * C, C, a.eps, red);

      // ---- FFN (exact GELU) ---------------------------------------------
      gemv<T>(ring, 1, bp, nullptr, x, xa + i0);
      bp += Is;
      for (int i = i0 + threadIdx.x; i < i0 + Is; i += NT) xa[i] = rnd(gelu_exact(xa[i]), T());
      share(xa_x, xa, i0, Is, CL, rank);
      gemv<T>(ring, 1, bp, nullptr, xa, xb + c0);
      bp += Cs;
      share(xb_x, xb, c0, Cs, CL, rank);
      layer_norm<T>(x, xb, ln + 4 * C, ln + 5 * C, C, a.eps, red);
    }

    // ---- LM head: dense -> GELU -> LN -> tied projection + f32 bias ------
    gemv<T>(ring, 1, bp, nullptr, x, xa + c0);
    for (int c = c0 + threadIdx.x; c < c0 + Cs; c += NT) xa[c] = rnd(gelu_exact(xa[c]), T());
    share(xa_x, xa, c0, Cs, CL, rank);
    layer_norm<T>(xa, nullptr, lnp + 2 * C, lnp + 3 * C, C, a.eps, red);
    gemv<T, 8>(ring, 1, nullptr, hbias, xa, logits);  // the LM head: 8 rows a warp
    // ---- logit processors, top-k and sampling, in the plain loop's order.
    // Thread t owns logits[t + k NT] in every stage below, so only the
    // reductions over the slice and over the cluster need barriers.
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* dl = a.debug_logits ? a.debug_logits + ((long long)b * N + step) * V + v0 : nullptr;
    for (int i = threadIdx.x; i < nv; i += NT) {
      float z = logits[i];
      if (dl) dl[i] = z;  // the raw logits
      if (a.repetition_penalty != 1.f && rep[i]) z = z > 0.f ? z / a.repetition_penalty : z * a.repetition_penalty;
      if (v0 + i < a.ban_until) z = -INFINITY;
      logits[i] = z;
    }
    if (a.use_end_gate) {
      // the slice's (max, sum of exp) from the warps' pairs, and the EOS
      // logit from the block that holds it; merged in rank order by every block
      float m = -INFINITY, s = 0.f;
      for (int i = threadIdx.x; i < nv; i += NT) m = fmaxf(m, logits[i]);
      m = warp_max(m);
      if (m > -INFINITY)  // a warp whose elements are all -inf (banned) adds nothing
        for (int i = threadIdx.x; i < nv; i += NT) s += expf(logits[i] - m);
      s = warp_sum(s);
      if (lane == 0) {
        red[warp] = m;
        red[NW + warp] = s;
      }
      csync();
      if (threadIdx.x == 0) {
        float bm = -INFINITY, bs = 0.f;
        for (int w = 0; w < NW; ++w) bm = fmaxf(bm, red[w]);
        for (int w = 0; w < NW; ++w) bs += red[w] == -INFINITY ? 0.f : red[NW + w] * expf(red[w] - bm);
        expect(gate_xc, static_cast<uint32_t>(CL * 12));
        const bool mine = a.eos >= v0 && a.eos < v0 + nv;
        const float z = mine ? logits[a.eos - v0] : -INFINITY;
        for (int r = 0; r < CL; ++r) {
          push(gate_x + 4 * rank, bm, gate_xc.bar, r);
          push(gate_x + 4 * rank + 1, bs, gate_xc.bar, r);
          push(gate_x + 4 * rank + 2, z, gate_xc.bar, r);
        }
      }
      receive(gate_xc);
      float gm = -INFINITY, z_eos = -INFINITY;
      for (int r = 0; r < CL; ++r) { gm = fmaxf(gm, gate_x[4 * r]); z_eos = fmaxf(z_eos, gate_x[4 * r + 2]); }
      float gs = 0.f;
      for (int r = 0; r < CL; ++r)
        gs += gate_x[4 * r] == -INFINITY ? 0.f : gate_x[4 * r + 1] * expf(gate_x[4 * r] - gm);
      const float p_eos = expf(z_eos - gm) / gs;
      if (p_eos > a.end_gate)
        for (int i = threadIdx.x; i < nv; i += NT) logits[i] = (v0 + i == a.eos) ? 0.f : -INFINITY;
    }
    if (a.do_sample && a.temperature != 1.f)
      for (int i = threadIdx.x; i < nv; i += NT) logits[i] = logits[i] / a.temperature;
    if (a.do_sample && a.top_k > 0) {
      // k rounds of (max over the values below the previous max) give the
      // descending top-k values, exact ties collapsing into one slot: each
      // warp over its elements, warp 0 over the warps' lists (the block's
      // list, sent to every block of the cluster), then every warp over the
      // CL lists.  Each stage's union holds the top-k of the whole, so every
      // warp of every block ends with the global values.
      const int kk = min(a.top_k, V);
      float prev = INFINITY;
      for (int r = 0; r < kk; ++r) {
        float m = -INFINITY;
        for (int i = threadIdx.x; i < nv; i += NT) {
          const float z = logits[i];
          if (z < prev) m = fmaxf(m, z);
        }
        prev = warp_max(m);
        if (lane == 0) wk[warp * kk + r] = prev;
      }
      csync();
      if (warp == 0) {
        if (lane == 0) expect(topk_xc, static_cast<uint32_t>(CL * kk * 4));
        prev = INFINITY;
        for (int r = 0; r < kk; ++r) {
          float m = -INFINITY;
          for (int j = lane; j < NW * kk; j += 32) {
            const float z = wk[j];
            if (z < prev) m = fmaxf(m, z);
          }
          prev = warp_max(m);
          if (lane < CL) push(topk_x + rank * kk + r, prev, topk_xc.bar, lane);
        }
      }
      receive(topk_xc);  // also: warp 0 is done reading wk (its pushes include this block's own)
      float* vals = wk + warp * MAX_TOP_K;  // this warp's copy of the global values
      prev = INFINITY;
      for (int r = 0; r < kk; ++r) {
        float m = -INFINITY;
        for (int j = lane; j < CL * kk; j += 32) {
          const float z = topk_x[j];
          if (z < prev) m = fmaxf(m, z);
        }
        prev = warp_max(m);
        if (lane == 0) vals[r] = prev;
      }
      __syncwarp();
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
      for (int i = threadIdx.x; i < nv; i += NT)
        if (logits[i] < cut) logits[i] = -INFINITY;
    }

    // ---- sample (Gumbel-max) or greedy argmax: each warp's (value, index),
    // then warp 0's lanes merge the block's pairs and send them on
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int i = threadIdx.x; i < nv; i += NT) {
      float y = logits[i];
      const int gi = v0 + i;
      if (a.do_sample) {
        const uint32_t bits = philox(static_cast<uint32_t>(gi), static_cast<uint32_t>(step),
                                     static_cast<uint32_t>(b), 0u, key0, key1);
        const float u = (static_cast<float>(bits >> 8) + 0.5f) * (1.f / 16777216.f);
        y += -logf(-logf(u));
      }
      argmax_merge(best, best_i, y, gi);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, best_i, o);
      argmax_merge(best, best_i, v2, i2);
    }
    if (lane == 0) {
      red[warp] = best;
      redi[warp] = best_i;
    }
    csync();
    if (warp == 0) {
      if (lane == 0) expect(best_xc, static_cast<uint32_t>(CL * 8));
      if (lane < CL) {
        float bv = -INFINITY;
        int bi = 0x7fffffff;
        for (int w = 0; w < NW; ++w) argmax_merge(bv, bi, red[w], redi[w]);
        push(best_x + 2 * rank, bv, best_xc.bar, lane);
        push(best_x + 2 * rank + 1, __int_as_float(bi), best_xc.bar, lane);
      }
    }
    receive(best_xc);
    best = -INFINITY;
    best_i = 0x7fffffff;
    for (int r = 0; r < CL; ++r) argmax_merge(best, best_i, best_x[2 * r], __float_as_int(best_x[2 * r + 1]));
    tok = best_i;
    if (threadIdx.x == 0) {
      if (rank == 0) a.tokens[(long long)b * N + step] = tok;
      if (tok >= v0 && tok < v0 + nv) rep[tok - v0] = 1;
    }
    ++count;
    finished = (tok == a.eos);
  }

  // PAD after EOS; lengths count the EOS
  if (rank == 0) {
    for (int i = step + threadIdx.x; i < N; i += NT) a.tokens[(long long)b * N + i] = a.pad;
    if (threadIdx.x == 0) a.lengths[b] = count;
  }
  // Stop the copy warp: let the S copies already issued (for steps that will
  // not run) land, then raise the flag and free the slot it waits for.
  const int slot0 = ring.slot;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.S; ++s) {
      bar_wait(ring.full + ring.slot, ring.parity);
      ring_next(ring);
    }
    *stop = 1;
  }
  csync();
  if ((threadIdx.x & 31) == 0) bar_arrive(ring.empty + slot0);
  cluster.sync();  // no block leaves while a peer may still touch its shared memory
}

template <typename T>
cudaLaunchConfig_t config(const ArDecodeArgs& a, cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.CL);
  cfg.blockDim = dim3(NT + 32);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan the wrapper passes, checked against the kernel's own rules.
int check(const ArDecodeArgs& a, int elem) {
  // C <= PER NT: LayerNorm and the rotary step keep PER channels per thread
  // in registers; D % 4 == 0: attention scores read keys four at a time
  if (a.top_k > MAX_TOP_K || a.C % 8 != 0 || a.I % 8 != 0 || a.C > PER * NT || a.H <= 0 ||
      a.C % a.H != 0 || (a.C / a.H) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.CL < 1 || a.CL > 8 || a.H % a.CL != 0 || a.nh != a.H / a.CL || a.C % a.CL != 0 || a.I % a.CL != 0 ||
      a.Vs != (a.V + a.CL - 1) / a.CL || (a.kv_smem == 0 && a.kv_cache == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the ring: at least two slots, each holding a whole row of every matrix
  const int row_max = (a.C > a.I ? a.C : a.I) * elem;
  if (a.stages < 2 || a.chunk % 16 != 0 || a.chunk < row_max)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.smem_bytes != layout(a, elem).total || a.smem_bytes > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int launch(const ArDecodeArgs* args, void* stream) {
  const ArDecodeArgs& a = *args;
  if (int e = check(a, sizeof(T))) return e;
  cudaError_t e = cudaFuncSetAttribute(ar_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       a.smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T>(a, attr, stream);
  e = cudaLaunchKernelEx(&cfg, ar_decode_kernel<T>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_active_clusters(const ArDecodeArgs* args, int* out) {
  const ArDecodeArgs& a = *args;
  if (int e = check(a, sizeof(T))) return e;
  cudaError_t e = cudaFuncSetAttribute(ar_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       a.smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T>(a, attr, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, ar_decode_kernel<T>, &cfg));
}

}  // namespace

extern "C" int ar_decode_bf16(const ArDecodeArgs* args, void* stream) {
  return launch<__nv_bfloat16>(args, stream);
}

extern "C" int ar_decode_f32(const ArDecodeArgs* args, void* stream) {
  return launch<float>(args, stream);
}

// cudaOccupancyMaxActiveClusters for the launch `args` describes (its
// cluster size and shared memory): how many clusters fit on the card at once
extern "C" int ar_decode_max_active_clusters_bf16(const ArDecodeArgs* args, int* out) {
  return max_active_clusters<__nv_bfloat16>(args, out);
}

extern "C" int ar_decode_max_active_clusters_f32(const ArDecodeArgs* args, int* out) {
  return max_active_clusters<float>(args, out);
}
