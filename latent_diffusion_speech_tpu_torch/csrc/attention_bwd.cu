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
// (five T x T x D products per head) on the CUDA cores in f32 (the trainer
// turns TF32 off), a few to 14 µs of bound; the work per head is small, so
// what sets the time is how much of the card runs at once and the latency
// of each block's chain of loads and barriers.
//
// Design: a grid over (key tile, head group).  A block of 128 threads
// holds one key tile of TILE keys (K, V in shared memory) and walks every
// query tile: it loads the tile's q, do and out rows (the next tile's rows
// are loaded into registers while the current one computes; 4-element
// vector loads where the (b, t, h) strides and pointers allow), forms
// delta, p and ds in shared memory, accumulates dk and dv for its keys in
// registers and writes the tile's ds k.  With one key tile (T <= TILE) that
// is dq itself; with several, each block writes its partial dq tile to f32
// scratch, and the last block of a head to finish (an atomic counter, reset
// after use) adds the partials in key-tile order: dq has no atomics in its
// sums, so two calls give bit-identical results.  Where T <= 16 a block
// takes four heads, one warp each with TILE = 16 (the TPU kernel groups g
// heads a program likewise), so its threads have work and a head needs
// only warp barriers.  Inputs are read through their (b, t, h) strides, as
// the forward reads them, so q/k/v may be views of a fused projection and
// dout may come from autograd with any row stride.

#include "attention_fwd.cuh"

#include <stddef.h>

// One launch's arguments, packed by the wrapper (`BWD_ARGS`, field by field
// as `BWD_ARG_NAMES` names them).
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B*H, T)
  void* dq;          // (B, T, H, D) contiguous, as dk and dv
  void* dk;
  void* dv;
  float* dq_part;    // (B*H, n_kt, T, D) f32 scratch when n_kt > 1, else null
  int* counters;     // (B*H,) zero on entry, zero on exit, when n_kt > 1
  void* stream;
  long long s[15];   // (b, t, h) strides of q, k, v, out, dout in elements
  int B, T, H, D, tile, vec;
  float scale;
};
static_assert(sizeof(BwdArgs) == 248, "BwdArgs must match the wrapper's packing");
// each field where the wrapper packs it (tests/test_torch_attention_mma.py
// holds these offsets to the wrapper's `BWD_ARGS` and `BWD_ARG_NAMES`)
#define ARG_AT(field, offset) \
  static_assert(offsetof(BwdArgs, field) == (offset), "BwdArgs." #field " must sit where the wrapper packs it")
ARG_AT(q, 0);
ARG_AT(k, 8);
ARG_AT(v, 16);
ARG_AT(o, 24);
ARG_AT(dout, 32);
ARG_AT(lse, 40);
ARG_AT(dq, 48);
ARG_AT(dk, 56);
ARG_AT(dv, 64);
ARG_AT(dq_part, 72);
ARG_AT(counters, 80);
ARG_AT(stream, 88);
ARG_AT(s, 96);
ARG_AT(B, 216);
ARG_AT(T, 220);
ARG_AT(H, 224);
ARG_AT(D, 228);
ARG_AT(tile, 232);
ARG_AT(vec, 236);
ARG_AT(scale, 240);
#undef ARG_AT

namespace {

using lds_attn::from_f;
using lds_attn::round_to;
using lds_attn::to_f;

constexpr int NT = 128;  // threads per block

// four consecutive elements as f32: one 16-byte (f32) or 8-byte (bf16) load
__device__ __forceinline__ float4 ld4v(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4v(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
template <typename T>
__device__ __forceinline__ float4 ld4s(const T* p) {
  return make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
}

// Shared memory of one head group (floats): the K, V, Q, dO and O tiles
// (TILE x DP, 16-byte chunks of a row swizzled by `sw`), P and dS (TILE x
// TILE, query row major), dS transposed, the lse and delta rows.
__host__ __device__ constexpr int row_floats(int D) { return D == 48 ? 64 : D; }
__host__ __device__ constexpr int group_floats(int D, int TILE) {
  return 5 * TILE * row_floats(D) + 3 * TILE * TILE + 2 * TILE;
}

// Physical 16-byte chunk of chunk c in row r: the low three bits XORed with
// (r / 4) % 8, so the rows a warp reads together (4 apart, or consecutive
// quads) fall in different banks.  D = 48 rows are padded to 16 chunks.
__device__ __forceinline__ int sw(int r, int c) { return (c & ~7) | ((c ^ (r >> 2)) & 7); }

template <int D, int TILE>
struct Group {
  static constexpr int NG = TILE * TILE / 8;   // threads of a head group
  static constexpr int Q = TILE / 4;           // 4-row (4-key) quads of a tile
  static constexpr int D4 = D / 4;             // 4-dim quads of a row
  static constexpr int DP = row_floats(D);     // floats a smem row
  static constexpr int NCH = TILE * D4 / NG;   // 4-element chunks a thread loads per tile
  static constexpr int SA = (2 * Q * D4 + NG - 1) / NG;  // dv / dk quad pairs a thread
  static constexpr int SQ = (Q * D4 + NG - 1) / NG;      // dq quad pairs a thread
};

// the group's barrier: the block (TILE = 32) or the warp (TILE = 16)
template <int TILE>
__device__ __forceinline__ void gsync() {
  if (TILE == 32) __syncthreads();
  else __syncwarp();
}

// rows [r0, r0 + TILE) of a (T, D) head view, chunk c = gt + NG i of the
// tile (row c / D4, 4 columns); rows past n are zero
template <typename T, int D, int TILE>
__device__ __forceinline__ void fetch(float4 (&dst)[Group<D, TILE>::NCH], const T* src, long long st, int r0,
                                      int n, int gt, bool vec) {
  using G = Group<D, TILE>;
#pragma unroll
  for (int i = 0; i < G::NCH; ++i) {
    const int c = gt + G::NG * i, r = c / G::D4, col = (c % G::D4) * 4;
    const T* p = src + (long long)(r0 + r) * st + col;
    dst[i] = r < n ? (vec ? ld4v(p) : ld4s(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D, int TILE>
__device__ __forceinline__ void store(float* dst, const float4 (&src)[Group<D, TILE>::NCH], int gt) {
  using G = Group<D, TILE>;
#pragma unroll
  for (int i = 0; i < G::NCH; ++i) {
    const int c = gt + G::NG * i, r = c / G::D4;
    *reinterpret_cast<float4*>(dst + r * G::DP + sw(r, c % G::D4) * 4) = src[i];
  }
}

// row r, 4-dim quad c of a swizzled tile
template <int D, int TILE>
__device__ __forceinline__ float4 at(const float* t, int r, int c) {
  return *reinterpret_cast<const float4*>(t + r * Group<D, TILE>::DP + sw(r, c) * 4);
}

__device__ __forceinline__ void fma4x4(float (&acc)[16], const float4& a, const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[x * 4 + u] = fmaf(av[x], bv[u], acc[x * 4 + u]);
}

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(NT, TILE == 32 ? 3 : 2) attention_bwd_kernel(const BwdArgs a) {
  using G = Group<D, TILE>;
  constexpr int NG = G::NG, Q = G::Q, D4 = G::D4, DP = G::DP, NCH = G::NCH, SA = G::SA, SQ = G::SQ;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, gt = tid % NG, grp = tid / NG;
  const int H = a.H, T_len = a.T;
  const int bh = blockIdx.y * (NT / NG) + grp;
  if (bh >= a.B * H) return;  // a head group past the last head (TILE = 16: a warp of its own)
  const int b = bh / H, h = bh % H;
  const int kt = blockIdx.x, n_kt = gridDim.x, k0 = kt * TILE, nk = min(TILE, T_len - k0);

  float* ks = smem + grp * group_floats(D, TILE);
  float* vs = ks + TILE * DP;
  float* qs = vs + TILE * DP;
  float* dos = qs + TILE * DP;
  float* os = dos + TILE * DP;
  float* ps = os + TILE * DP;   // (query row, key): p in f32, before rounding
  float* dss = ps + TILE * TILE;  // (query row, key): dp, then ds
  float* dst = dss + TILE * TILE;  // (key, query row): ds
  float* lse_s = dst + TILE * TILE;
  float* delta_s = lse_s + TILE;

  const T* qb = static_cast<const T*>(a.q) + b * a.s[0] + h * a.s[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.s[3] + h * a.s[5];
  const T* vb = static_cast<const T*>(a.v) + b * a.s[6] + h * a.s[8];
  const T* ob = static_cast<const T*>(a.o) + b * a.s[9] + h * a.s[11];
  const T* dob = static_cast<const T*>(a.dout) + b * a.s[12] + h * a.s[14];
  const float* lse_bh = a.lse + (long long)bh * T_len;
  const bool vec = a.vec != 0;
  const float scale = a.scale;

  // ---- this block's key tile, and the first query tile into registers
  {
    float4 kr[NCH], vr[NCH];
    fetch<T, D, TILE>(kr, kb, a.s[4], k0, nk, gt, vec);
    fetch<T, D, TILE>(vr, vb, a.s[7], k0, nk, gt, vec);
    store<D, TILE>(ks, kr, gt);
    store<D, TILE>(vs, vr, gt);
  }
  float4 qr[NCH], dor[NCH], orr[NCH];
  fetch<T, D, TILE>(qr, qb, a.s[1], 0, min(TILE, T_len), gt, vec);
  fetch<T, D, TILE>(dor, dob, a.s[13], 0, min(TILE, T_len), gt, vec);
  fetch<T, D, TILE>(orr, ob, a.s[10], 0, min(TILE, T_len), gt, vec);

  float acc[SA][16];  // dv (pairs < Q D4) and dk quads: 4 keys x 4 dims each
#pragma unroll
  for (int s = 0; s < SA; ++s)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[s][e] = 0.f;

  T* dq_out = static_cast<T*>(a.dq);
  float* part = a.dq_part ? a.dq_part + ((long long)bh * n_kt + kt) * T_len * D : nullptr;
  for (int q0 = 0; q0 < T_len; q0 += TILE) {
    const int nq = min(TILE, T_len - q0);
    gsync<TILE>();  // the previous tile's smem is consumed
    store<D, TILE>(qs, qr, gt);
    store<D, TILE>(dos, dor, gt);
    store<D, TILE>(os, orr, gt);
    if (gt < TILE) lse_s[gt] = gt < nq ? lse_bh[q0 + gt] : 0.f;
    gsync<TILE>();
    if (TILE == 32 && q0 + TILE < T_len) {  // the next query tile's rows, in flight while this one computes
      const int n2 = min(TILE, T_len - q0 - TILE);
      fetch<T, D, TILE>(qr, qb, a.s[1], q0 + TILE, n2, gt, vec);
      fetch<T, D, TILE>(dor, dob, a.s[13], q0 + TILE, n2, gt, vec);
      fetch<T, D, TILE>(orr, ob, a.s[10], q0 + TILE, n2, gt, vec);
    }

    // ---- s = q k^T (threads < Q^2) and dp = do v^T (the others): 4 rows x
    // 4 keys a thread; delta = rowsum(do * out) on the side
    {
      const bool is_s = gt < Q * Q;
      const int pq = is_s ? gt : gt - Q * Q, rq = pq / Q, kq = pq % Q;
      const float* A = is_s ? qs : dos;
      const float* Bm = is_s ? ks : vs;
      const float* Ab = A + rq * 4 * DP;  // the thread's 4 rows share their swizzle
      const float* Bb = Bm + kq * 4 * DP;
      float sum[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) sum[e] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D4; ++c) {
        const int ca = sw(rq * 4, c) * 4, cb = sw(kq * 4, c) * 4;
        float4 av[4], bv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          av[x] = *reinterpret_cast<const float4*>(Ab + x * DP + ca);
          bv[x] = *reinterpret_cast<const float4*>(Bb + x * DP + cb);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            sum[x * 4 + u] = fmaf(av[x].x, bv[u].x, fmaf(av[x].y, bv[u].y,
                             fmaf(av[x].z, bv[u].z, fmaf(av[x].w, bv[u].w, sum[x * 4 + u]))));
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = rq * 4 + x;
        float v4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = kq * 4 + u;
          const bool live = i < nq && j < nk;
          v4[u] = !live ? 0.f : is_s ? expf(__fmul_rn(sum[x * 4 + u], scale) - lse_s[i]) : sum[x * 4 + u];
        }
        *reinterpret_cast<float4*>((is_s ? ps : dss) + i * TILE + kq * 4) = make_float4(v4[0], v4[1], v4[2], v4[3]);
      }
      if (gt < TILE) {
        float d = 0.f;
#pragma unroll 4
        for (int c = 0; c < D4; ++c) {
          const float4 x = at<D, TILE>(dos, gt, c), y = at<D, TILE>(os, gt, c);
          d = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, d))));
        }
        delta_s[gt] = d;
      }
    }
    gsync<TILE>();

    // ---- ds = p (dp - delta) scale, rounded to the input dtype
    for (int e = gt; e < TILE * TILE; e += NG) {
      const int i = e / TILE, j = e % TILE;
      const float ds = round_to(__fmul_rn(ps[e] * (dss[e] - delta_s[i]), scale), T());
      dss[e] = ds;
      dst[j * TILE + i] = ds;
    }
    gsync<TILE>();

    // ---- dv += p^T do, dk += ds^T q: a thread's quads of 4 keys x 4 dims
#pragma unroll
    for (int s = 0; s < SA; ++s) {
      const int pid = gt + NG * s;
      if (pid < 2 * Q * D4) {
        const bool dk_part = pid >= Q * D4;
        const int rem = dk_part ? pid - Q * D4 : pid, kq = rem / D4, c = rem % D4;
        const float* P = dk_part ? dss : ps;
        const float* X = dk_part ? qs : dos;
        // every row of the tile: rows past nq hold p = ds = 0 and zero q, do
#pragma unroll 2
        for (int i0 = 0; i0 < TILE; i0 += 4) {
          const int co = sw(i0, c) * 4;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = i0 + x;
            float4 p = *reinterpret_cast<const float4*>(P + i * TILE + kq * 4);
            p = make_float4(round_to(p.x, T()), round_to(p.y, T()), round_to(p.z, T()), round_to(p.w, T()));
            fma4x4(acc[s], p, *reinterpret_cast<const float4*>(X + i * DP + co));
          }
        }
      }
    }

    // ---- this key tile's ds k: 4 query rows x 4 dims a thread
#pragma unroll
    for (int s = 0; s < SQ; ++s) {
      const int pid = gt + NG * s;
      if (pid < Q * D4) {
        const int rq = pid / D4, c = pid % D4;
        float dq[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) dq[e] = 0.f;
        // every key of the tile: keys past nk hold ds = 0 and zero k
#pragma unroll 2
        for (int j0 = 0; j0 < TILE; j0 += 4) {
          const int co = sw(j0, c) * 4;
#pragma unroll
          for (int x = 0; x < 4; ++x)
            fma4x4(dq, *reinterpret_cast<const float4*>(dst + (j0 + x) * TILE + rq * 4),
                   *reinterpret_cast<const float4*>(ks + (j0 + x) * DP + co));
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = rq * 4 + x;
          if (i >= nq) continue;
          if (part) {
            *reinterpret_cast<float4*>(part + (long long)(q0 + i) * D + c * 4) =
                make_float4(dq[x * 4], dq[x * 4 + 1], dq[x * 4 + 2], dq[x * 4 + 3]);
          } else {
            T* row = dq_out + (((long long)b * T_len + q0 + i) * H + h) * D + c * 4;
#pragma unroll
            for (int u = 0; u < 4; ++u) from_f(row[u], dq[x * 4 + u]);
          }
        }
      }
    }
  }

  // ---- dk, dv of this key tile (contiguous (B, T, H, D))
#pragma unroll
  for (int s = 0; s < SA; ++s) {
    const int pid = gt + NG * s;
    if (pid < 2 * Q * D4) {
      const bool dk_part = pid >= Q * D4;
      const int rem = dk_part ? pid - Q * D4 : pid, kq = rem / D4, c = rem % D4;
      T* out = static_cast<T*>(dk_part ? a.dk : a.dv);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = kq * 4 + x;
        if (j >= nk) continue;
        T* row = out + (((long long)b * T_len + k0 + j) * H + h) * D + c * 4;
#pragma unroll
        for (int u = 0; u < 4; ++u) from_f(row[u], acc[s][x * 4 + u]);
      }
    }
  }

  // ---- several key tiles: the head's last block adds the partials in order
  if (part) {
    __shared__ int last;
    __threadfence();  // this block's partial is visible before it is counted
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.counters + bh, 1) == n_kt - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      const float* p0 = a.dq_part + (long long)bh * n_kt * T_len * D;
      for (int idx = tid; idx < T_len * D4; idx += NT) {  // 4 elements a step
        const float4* p4 = reinterpret_cast<const float4*>(p0) + idx;
        float4 sum = __ldcg(p4);  // from L2: other blocks wrote them
        for (int t = 1; t < n_kt; ++t) {
          const float4 x = __ldcg(p4 + (long long)t * T_len * D4);
          sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
        }
        const int i = idx / D4, c = idx % D4;
        T* row = dq_out + (((long long)b * T_len + i) * H + h) * D + c * 4;
        from_f(row[0], sum.x);
        from_f(row[1], sum.y);
        from_f(row[2], sum.z);
        from_f(row[3], sum.w);
      }
      if (tid == 0) a.counters[bh] = 0;  // ready for the next call
    }
  }
}

template <typename T, int D, int TILE>
int launch_tile(const BwdArgs& a) {
  const int heads_per_block = NT / Group<D, TILE>::NG;
  const int n_kt = (a.T + TILE - 1) / TILE;
  const size_t smem = sizeof(float) * group_floats(D, TILE) * heads_per_block;
  // the shared-memory opt-in, once a device and process (a repeat is harmless)
  static unsigned long long opted_in = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 64 || !((opted_in >> device) & 1ull)) {
    e = cudaFuncSetAttribute(attention_bwd_kernel<T, D, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) opted_in |= 1ull << device;
  }
  dim3 grid(n_kt, (a.B * a.H + heads_per_block - 1) / heads_per_block);
  attention_bwd_kernel<T, D, TILE><<<grid, NT, smem, static_cast<cudaStream_t>(a.stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_d(const BwdArgs& a) {
  if (a.tile == 16 && a.T <= 16) return launch_tile<T, D, 16>(a);
  if (a.tile == 32) return launch_tile<T, D, 32>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const BwdArgs* args) {
  const BwdArgs& a = *args;
  const int tile = a.tile, n_kt = (a.T + tile - 1) / tile;
  if ((n_kt > 1) != (a.dq_part != nullptr) || (n_kt > 1 && a.counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a.D) {
    case 32: return launch_d<T, 32>(a);
    case 48: return launch_d<T, 48>(a);
    case 64: return launch_d<T, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int attention_bwd_bf16(const BwdArgs* args) { return launch<__nv_bfloat16>(args); }

extern "C" int attention_bwd_f32(const BwdArgs* args) { return launch<float>(args); }
