// K4 forward: non-causal self-attention over (B, T, H, D), for the UNet's
// transformer blocks.
//
// Replaces: latent_diffusion_speech_tpu/ops/pallas/fused_attention.py,
// function `fused_attention` (forward `_fused_fwd` / `_fwd_kernel`).
//
// Numerics (the TPU kernel's): f32 scores and softmax statistics; the
// normalised probability p = exp(s - m) / l is rounded to the input dtype
// before p @ v, which accumulates in f32; the f32 log-sum-exp m + log l of
// every row is written for the backward.
//
// Two kernels, one per entry:
//
// attention_fwd_bf16 (tensor cores; the serve path's).  What bounds it on
// this card: at the UNet's shapes (T = 56..448, D = 32..64, H = 8, B = 1..4;
// the general denoiser's block zoo: D = 8, H = 32..64)
// a call moves well under 1 MB and does 0.01-0.3 GFLOP (three T x T x D
// products per head: q.k twice, p.v once), so it is bound by latency (a
// warp's serial walk over the keys) and, back to back, by the host's
// launch; at T = 1024 the products dominate.  Design (attention_mma.cuh): a
// block of 64 query rows (four warps, 16 rows each); bf16 64-key tiles
// double-buffered through shared memory by cp.async.  The body is
// `lds_mma::attention_fwd_rows`, shared with the fused UNet kernel.  Pass 1
// walks the K tiles: S = Q K^T by mma.sync in f32, times scale, and a running (max,
// sum) per row and thread; the four threads of a row merge theirs into m and
// l.  Pass 2 walks the K and V tiles again, recomputes S (bit for bit),
// forms p = exp(s - m) * (1 / l) rounded to bf16 (the normalised p, as the
// TPU kernel rounds it), and that bf16 fragment is the A operand of the
// P V MMA.  The two passes are one stream of tiles, so pass 2's first tile
// loads while pass 1's last computes.  The TPU kernel held the whole (T, T)
// score tile in VMEM, which capped T at 512; here the scores never
// materialise, so any T works.
//
// attention_fwd_f32 and attention_fwd_simt_bf16 (CUDA cores): the body is
// `lds_attn::attention_tile` in attention_fwd.cuh (shared with the fused
// UNet kernel), one tile per block, grid (query tiles, B * H).  f32 is the
// trainer's dtype (its contract, atol 2e-5, is beyond bf16 products); the
// bf16 instantiation is a yardstick that no serve or training path calls.

#include <stddef.h>
#include <string.h>

#include "attention_fwd.cuh"
#include "attention_mma.cuh"

namespace {

// ---- CUDA cores (f32, and the bf16 yardstick)

template <typename T, int D>
__global__ void __launch_bounds__(lds_attn::NT) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse,
    int H, int T_len,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    float scale) {
  __shared__ float smem[lds_attn::attention_smem_floats(D)];
  lds_attn::attention_tile<T, D>(q, k, v, out, lse, H, T_len, sqb, sqt, sqh, skb, skt, skh,
                                 svb, svt, svh, scale, blockIdx.y, blockIdx.x, smem);
}

// ---- tensor cores (bf16)

template <int D>
__global__ void __launch_bounds__(lds_mma::NT) attention_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int H, int T_len,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    float scale) {
  __shared__ __align__(16) lds_mma::Smem<D> sm;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  lds_mma::attention_fwd_rows<D>(q + b * sqb + h * sqh, k + b * skb + h * skh, v + b * svb + h * svh, sqt, skt,
                                 svt, out + ((long long)b * T_len * H + h) * D, (long long)H * D,
                                 lse + (long long)bh * T_len, T_len, scale, blockIdx.x, sm);
}

// ---- launches

// One launch's arguments, packed by the Python wrapper (`ARGS` in
// ops/kernels/fused_attention.py, "<6q9q4if4x"): one ctypes argument
// instead of 20.  Strides are (q, k, v) x (b, t, h), in elements; the head
// dim is contiguous; out is contiguous (B, T, H, D), lse (B * H, T) f32.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  void* stream;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  int B, T, H, D;
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
ARG_AT(lse, 32);
ARG_AT(stream, 40);
ARG_AT(sqb, 48);
ARG_AT(sqt, 56);
ARG_AT(sqh, 64);
ARG_AT(skb, 72);
ARG_AT(skt, 80);
ARG_AT(skh, 88);
ARG_AT(svb, 96);
ARG_AT(svt, 104);
ARG_AT(svh, 112);
ARG_AT(B, 120);
ARG_AT(T, 124);
ARG_AT(H, 128);
ARG_AT(D, 132);
ARG_AT(scale, 136);
#undef ARG_AT

template <typename T>
int launch_simt(const Args& a) {
  dim3 grid((a.T + lds_attn::BQ - 1) / lds_attn::BQ, a.B * a.H);
  dim3 block(lds_attn::NT);
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
#define LAUNCH_D(DV)                                                                          \
  attention_fwd_kernel<T, DV><<<grid, block, 0, s>>>(                                         \
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),    \
      static_cast<T*>(a.out), a.lse, a.H, a.T, a.sqb, a.sqt, a.sqh, a.skb, a.skt, a.skh,      \
      a.svb, a.svt, a.svh, a.scale)
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
  dim3 grid((a.T + lds_mma::BM - 1) / lds_mma::BM, a.B * a.H);
  dim3 block(lds_mma::NT);
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
#define LAUNCH_D(DV)                                                                          \
  attention_fwd_mma_kernel<DV><<<grid, block, 0, s>>>(                                        \
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),         \
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.out), a.lse, a.H, \
      a.T, a.sqb, a.sqt, a.sqh, a.skb, a.skt, a.skh, a.svb, a.svt, a.svh, a.scale)
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
extern "C" int attention_fwd_bf16(const void* packed) { return launch_mma(unpack(packed)); }

extern "C" int attention_fwd_simt_bf16(const void* packed) {
  return launch_simt<__nv_bfloat16>(unpack(packed));
}

extern "C" int attention_fwd_f32(const void* packed) { return launch_simt<float>(unpack(packed)); }
