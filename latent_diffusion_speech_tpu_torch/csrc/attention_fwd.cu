// K4 forward: non-causal self-attention over (B, T, H, D), for the UNet's
// transformer blocks.
//
// Replaces: latent_diffusion_speech_tpu/ops/pallas/fused_attention.py,
// function `fused_attention` (forward `_fused_fwd` / `_fwd_kernel`).
//
// What bounds it on this card: at the UNet's shapes (T = 56..448, D = 32..64,
// H = 8, B = 1..16) a call moves well under 1 MB and does 0.01-0.3 GFLOP
// (three T x T x D products per head: q.k twice, p.v once), so it is bound
// by latency and occupancy (8-112 blocks, short loops); at T = 1024 it does
// ~3 GFLOP on the CUDA cores (no tensor cores yet).  The TPU kernel held
// the whole (T, T) score tile in VMEM, which capped T at 512; a block here
// has at most 227 KB of shared memory, so the scores never materialise.
//
// Design: the body is `lds_attn::attention_tile` in attention_fwd.cuh (shared
// with the fused UNet kernel); this kernel runs one tile per block, grid
// (query tiles, B * H).

#include "attention_fwd.cuh"

namespace {

using lds_attn::BQ;
using lds_attn::NT;

template <typename T, int D>
__global__ void __launch_bounds__(NT) attention_fwd_kernel(
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int T_len, int H, int D,
           long long sqb, long long sqt, long long sqh,
           long long skb, long long skt, long long skh,
           long long svb, long long svt, long long svh,
           float scale, void* stream) {
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  dim3 block(NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_D(DV)                                                          \
  attention_fwd_kernel<T, DV><<<grid, block, 0, s>>>(                         \
      static_cast<const T*>(q), static_cast<const T*>(k),                     \
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, T_len,          \
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, scale)
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

extern "C" int attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int T_len, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, lse, B, T_len, H, D, sqb, sqt, sqh,
                               skb, skt, skh, svb, svt, svh, scale, stream);
}

extern "C" int attention_fwd_f32(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int T_len, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    float scale, void* stream) {
  return launch<float>(q, k, v, out, lse, B, T_len, H, D, sqb, sqt, sqh,
                       skb, skt, skh, svb, svt, svh, scale, stream);
}
