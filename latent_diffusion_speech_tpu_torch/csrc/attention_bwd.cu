// K4 backward: gradients of non-causal self-attention over (B, T, H, D),
// for training the UNet's transformer blocks.
//
// Replaces: latent_diffusion_speech_tpu/ops/pallas/fused_attention.py,
// function `_fused_bwd` (kernel `_bwd_kernel`).  Same arithmetic: p is
// recomputed from (q, k) and the forward's f32 log-sum-exp rows,
//   delta = rowsum(do * out)           (f32)
//   dv    = p^T do                     (p rounded to the input dtype)
//   ds    = p * (do v^T - delta) * scale, rounded to the input dtype
//   dq    = ds k,   dk = ds^T q         (f32 accumulation, input-dtype out)
//
// What bounds it on this card: at the training shapes (B = 48, H = 8,
// T = 11..88, D = 32..64) a call moves 2-9 MB and does 0.05-0.5 GFLOP
// (five T x T x D products per head), so its bound is the bytes, a few
// microseconds; the work per head is small, so what sets its time is the
// latency of one head's short loops on the CUDA cores (no tensor cores yet).
//
// Design: the TPU kernel holds a whole (Tp, Tp) slab of G heads in VMEM,
// padded to 16 rows; here one block of 128 threads owns one (batch, head)
// and walks 32 x 32 tiles, so any T works and no score tile leaves shared
// memory.  Phase 0 writes delta for the head's rows.  Then for each key
// tile (K, V in shared memory) the block walks every query tile: it forms
// the tile's p and ds in shared memory, accumulates dk and dv for its keys
// in registers, and adds the tile's ds k to an f32 dq accumulator in
// device memory.  The thread that adds a dq element is the same in every
// key tile, so dq needs no atomics and its sums are ordered (deterministic).
// Inputs are read through their (b, t, h) strides, as the forward reads
// them, so q/k/v may be views of a fused projection and dout may come from
// autograd with any row stride.

#include "attention_fwd.cuh"

namespace {

using lds_attn::from_f;
using lds_attn::round_to;
using lds_attn::to_f;

constexpr int BT = 32;   // query rows and keys per tile
constexpr int NT = 128;  // threads per block

struct Strides {
  long long b, t, h;
};

// rows [r0, r0 + BT) of a (T, D) head view into dst[BT][D + 1]; rows past
// n are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1], const T* src, long long st, int r0,
                                          int n) {
  for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
    const int j = idx / D, d = idx % D;
    dst[j][d] = j < n ? to_f(src[(long long)(r0 + j) * st + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ delta, float* __restrict__ dq_acc,
    int H, int T_len, Strides sq, Strides sk, Strides sv, Strides so, Strides sdo, float scale) {
  constexpr int E = D / 4;  // dims per thread in the accumulation phases
  __shared__ float ks[BT][D + 1], vs[BT][D + 1], qs[BT][D + 1], dos[BT][D + 1];
  __shared__ float ps[BT][BT + 1], dss[BT][BT + 1];
  __shared__ float lse_s[BT], delta_s[BT];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* ob = o + b * so.b + h * so.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_bh = lse + (long long)bh * T_len;
  float* delta_bh = delta + (long long)bh * T_len;
  float* dqa = dq_acc + (long long)bh * T_len * D;

  // ---- phase 0: delta = rowsum(do * out) for every row of this head
  for (int r = tid; r < T_len; r += NT) {
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(to_f(dob[r * sdo.t + d]), to_f(ob[r * so.t + d]), s);
    delta_bh[r] = s;
  }

  const int n_tiles = (T_len + BT - 1) / BT;
  const int lane = tid & 31, d0 = tid >> 5;          // accumulation mapping
  const int r0 = (tid >> 3) * 2, c0 = (tid & 7) * 4;  // score mapping: rows r0, r0+1; keys c0..c0+3

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT, nk = min(BT, T_len - k0);
    __syncthreads();  // delta written; previous users of ks / vs done
    load_rows<T, D>(ks, kb, sk.t, k0, nk);
    load_rows<T, D>(vs, vb, sv.t, k0, nk);
    float dk_acc[E], dv_acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) dk_acc[e] = dv_acc[e] = 0.f;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * BT, nq = min(BT, T_len - q0);
      __syncthreads();  // previous tile's qs / dos / ps / dss consumed
      load_rows<T, D>(qs, qb, sq.t, q0, nq);
      load_rows<T, D>(dos, dob, sdo.t, q0, nq);
      if (tid < BT) {
        lse_s[tid] = tid < nq ? lse_bh[q0 + tid] : 0.f;
        delta_s[tid] = tid < nq ? delta_bh[q0 + tid] : 0.f;
      }
      __syncthreads();

      // ---- p and ds of the (query tile, key tile) pair
      {
        float s[2][4], dp[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int u = 0; u < 4; ++u) s[a][u] = dp[a][u] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float qa = qs[r0][d], qb2 = qs[r0 + 1][d];
          const float da = dos[r0][d], db = dos[r0 + 1][d];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float kk = ks[c0 + u][d], vv = vs[c0 + u][d];
            s[0][u] = fmaf(qa, kk, s[0][u]);
            s[1][u] = fmaf(qb2, kk, s[1][u]);
            dp[0][u] = fmaf(da, vv, dp[0][u]);
            dp[1][u] = fmaf(db, vv, dp[1][u]);
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int i = r0 + a;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = c0 + u;
            float p = 0.f, ds = 0.f;
            if (i < nq && j < nk) {
              const float pf = expf(__fmul_rn(s[a][u], scale) - lse_s[i]);
              p = round_to(pf, T());
              ds = round_to(__fmul_rn(pf * (dp[a][u] - delta_s[i]), scale), T());
            }
            ps[i][j] = p;
            dss[i][j] = ds;
          }
        }
      }
      __syncthreads();

      // ---- dv += p^T do and dk += ds^T q for key `lane` of the tile
      for (int i = 0; i < nq; ++i) {
        const float p = ps[i][lane], ds = dss[i][lane];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dv_acc[e] = fmaf(p, dos[i][d0 + 4 * e], dv_acc[e]);
          dk_acc[e] = fmaf(ds, qs[i][d0 + 4 * e], dk_acc[e]);
        }
      }

      // ---- dq rows of this query tile += ds k over the key tile
      {
        float acc[E];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = 0.f;
        for (int j = 0; j < nk; ++j) {
          const float ds = dss[lane][j];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = fmaf(ds, ks[j][d0 + 4 * e], acc[e]);
        }
        if (lane < nq) {
          float* row = dqa + (long long)(q0 + lane) * D;
#pragma unroll
          for (int e = 0; e < E; ++e) row[d0 + 4 * e] = kt == 0 ? acc[e] : row[d0 + 4 * e] + acc[e];
        }
      }
    }

    // ---- dk, dv of this key tile (contiguous (B, T, H, D))
    if (lane < nk) {
      const long long off = (((long long)b * T_len + k0 + lane) * H + h) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        from_f(dk[off + d0 + 4 * e], dk_acc[e]);
        from_f(dv[off + d0 + 4 * e], dv_acc[e]);
      }
    }
  }

  // ---- dq in the output dtype; each thread converts the sums it made
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int row = qt * BT + lane;
    if (row < T_len) {
      const long long off = (((long long)b * T_len + row) * H + h) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) from_f(dq[off + d0 + 4 * e], dqa[(long long)row * D + d0 + 4 * e]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* delta, float* dq_acc,
           int B, int T_len, int H, int D, const long long* strides, float scale, void* stream) {
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, so{strides[9], strides[10], strides[11]},
      sdo{strides[12], strides[13], strides[14]};
  dim3 grid(B * H);
  dim3 block(NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_D(DV)                                                                          \
  attention_bwd_kernel<T, DV><<<grid, block, 0, s>>>(                                         \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),           \
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq),        \
      static_cast<T*>(dk), static_cast<T*>(dv), delta, dq_acc, H, T_len, sq, sk, sv, so, sdo, \
      scale)
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

// strides: 15 values, (batch, time, head) strides of q, k, v, out, dout in
// elements; the head dim is contiguous.  dq/dk/dv are contiguous
// (B, T, H, D); delta (B*H, T) and dq_acc (B*H, T, D) are f32 scratch.
extern "C" int attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* delta, float* dq_acc,
    int B, int T_len, int H, int D, const long long* strides, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, dq_acc, B, T_len, H, D,
                               strides, scale, stream);
}

extern "C" int attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* delta, float* dq_acc,
    int B, int T_len, int H, int D, const long long* strides, float scale, void* stream) {
  return launch<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, dq_acc, B, T_len, H, D, strides,
                       scale, stream);
}
