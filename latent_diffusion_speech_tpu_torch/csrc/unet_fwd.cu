// K2 + K3: one whole UNet-1D denoiser forward at B=1 in one launch.
//
// Replaces: latent_diffusion_speech_tpu/ops/pallas/unet1d_fused.py,
// function `unet_fwd_pallas` (K2, segment kernels), and
// latent_diffusion_speech_tpu/ops/pallas/unet1d_stream.py, function
// `unet_fwd_pallas_stream` (K3, one call streaming the weights): both
// compute the same function, and this one kernel serves both.
//
// What bounds it on this card: the kernel streams the packed weights of the
// flagship UNet (256, 384, 512, 512): 98.0 M values, 196 MB in bf16, more
// than the 50 MB L2, so ~58 us a forward at 3.35 TB/s; the work is 4.7 /
// 35.4 / 90.1 GFLOP at T = 64 / 448 / 1024 (~91 us on the bf16 tensor cores
// at T = 1024).  The TPU kernels lost to ~67 us per `pallas_call` and a slow
// DMA queue; here the cost to beat is PyTorch's ~1300 launches per eager
// forward.  This version is still far from the bound (PERF.md): its phases
// are latency-bound (few items a block, two barriers a k step, 8 warps an
// SM), not bound by bytes or by the tensor cores.
//
// Design: a persistent cooperative kernel (grid = SMs x co-resident blocks,
// at most 2 per SM, launched with cudaLaunchCooperativeKernel) walks an
// int32 table of records built on the host (`ops/kernels/unet_fused.py`,
// field order in `enum Field`).  Each record is one of
//   GEMM  out = epilogue(sum_taps prologue(A[shifted rows]) @ W_tap): conv
//         k=3 (three taps of the same A; stride 2 reads rows 2t+k-1, nearest
//         x2 upsampling reads row (t+k-1)/2), the 1x1 shortcut, proj_in/out,
//         q|k|v as one (C, 3C) product, the attention output, GEGLU in and
//         out.  The prologue applies GroupNorm, the time scale/shift,
//         LayerNorm or the GEGLU gate, then SiLU, as A is loaded; A may be
//         the concatenation of two activations (the skip of an up block).
//         The epilogue adds the bias and the residual, and accumulates the
//         per-channel (GroupNorm) or per-row (LayerNorm) sum and sum of
//         squares of what it stores, for the record that normalises it next:
//         the statistics need no phase of their own.
//   ATTN  self-attention over q|k|v, through the K4 tile routine
//         (attention_fwd.cuh), one item per (head, 32 query rows).
// Records marked SYNC end a phase with a grid barrier (cooperative_groups
// grid sync); within a phase the records' items are dealt round-robin over
// the blocks.  A GEMM item is a 64 x 64 output tile, or one of its K splits:
// a record with fewer tiles than blocks splits K so that the items fill the
// grid, each split stores its f32 partial tile, and the block that brings
// the last split sums them in order (deterministic) and runs the epilogue.
// K runs in steps of 32 channels through shared memory; a thread loads 8
// consecutive channels of a row (or a weight row) as one vector, so every
// channel count must be a multiple of 8.  bf16 multiplies on the tensor
// cores (mma.sync m16n8k16, f32 accumulators; B fragments by
// ldmatrix.trans), f32 with SIMT FMAs, 8 x 4 accumulators a thread.  Values
// round to the storage dtype where the TPU kernel rounds: after every
// product, every norm and every elementwise step.  Activations, skips,
// statistics and split-K partials live in scratch the wrapper allocates;
// the kernel allocates nothing.

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_fwd.cuh"

namespace cg = cooperative_groups;

namespace {

using lds_attn::from_f;
using lds_attn::round_to;
using lds_attn::to_f;

// fields of one table record; ops/kernels/unet_fused.py::FIELDS lists the
// same names in the same order
enum Field : int {
  F_KIND = 0, F_A_BUF, F_A_OFF, F_A_LD, F_A_C, F_B_BUF, F_B_OFF, F_B_LD, F_B_C,
  F_T_IN, F_T_OUT, F_MODE, F_TAPS, F_N, F_W_OFF, F_BIAS_OFF, F_PRO, F_SILU, F_SS_OFF,
  F_GAMMA_OFF, F_BETA_OFF, F_CST_A, F_CST_B, F_GROUPS, F_OUT_BUF, F_OUT_OFF, F_OUT_LD,
  F_RES_BUF, F_RES_OFF, F_RES_LD, F_EPS, F_SYNC, F_ACC, F_CST_OUT, F_RST_A, F_RST_OUT,
};
constexpr int REC = 40;
enum Kind : int { KIND_GEMM = 1, KIND_ATTN = 2 };
enum Prologue : int { PRO_NONE = 0, PRO_GN = 1, PRO_LN = 2, PRO_GEGLU = 3 };
enum Mode : int { MODE_PLAIN = 0, MODE_DOWN = 1, MODE_UP = 2 };

constexpr int NT = lds_attn::NT;  // threads per block (128)
constexpr int BM = 64, BN = 64, BK = 32;  // GEMM tile
constexpr int TM = 8, TN = 4;             // accumulators per thread
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int MAX_GROUPS = 32;
static_assert((BM / TM) * (BN / TN) == NT, "one thread per 8 x 4 sub-tile");

struct GemmSmem {
  float a[BK][BM + 4];  // f32: A tile, k-major
  float b[BK][BN + 4];  // f32: W tile
  __nv_bfloat16 a16[BM][BK + 8];  // bf16: A tile, row-major (mma A fragments)
  __nv_bfloat16 b16[BK][BN + 8];  // bf16: W tile, row-major (ldmatrix.trans -> B fragments)
  // prologue coefficients of the k step's BK channels
  float c_mean[BK], c_rstd[BK], c_gamma[BK], c_beta[BK], c_scale[BK], c_shift[BK];
  float ln_mean[BM];         // LayerNorm: row statistics of the tile
  float ln_rstd[BM];
  float g_mean[MAX_GROUPS];  // GroupNorm: group statistics
  float g_rstd[MAX_GROUPS];
  int last;             // split-K: this block finishes the tile
};

constexpr size_t smem_bytes() {
  return sizeof(GemmSmem) > lds_attn::attention_smem_floats(64) * sizeof(float)
             ? sizeof(GemmSmem)
             : lds_attn::attention_smem_floats(64) * sizeof(float);
}

template <typename T>
struct Args {
  const int* ops;
  int n_ops;
  const T* w;       // packed weights (compute dtype)
  const float* p;   // packed norm scales/biases and biases (f32)
  const T* ss;      // time scale/shift rows of every res block
  T* ws;            // activation workspace (buffer 0)
  const T* x;       // input (buffer 1)
  T* y;             // output (buffer 2)
  float* stats;     // per-channel sums and sums of squares (GroupNorm inputs)
  int stats_elems;
  float* acc;       // split-K partial tiles: 2 regions of acc_elems >= grid * BM * BN (f32)
  int* cnt;         // split-K arrival counters: 2 regions of cnt_elems
  int acc_elems, cnt_elems;
  unsigned long long* clock;  // optional: ns timestamp after every barrier
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename T>
__device__ __forceinline__ T* bufp(const Args<T>& a, int buf, int off) {
  T* base = buf == 0 ? a.ws : (buf == 1 ? const_cast<T*>(a.x) : a.y);
  return base + off;
}

template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return round_to(x, T());
}

// an activation (T, ca) or the channel concatenation of two, (T, ca + cb)
template <typename T>
struct Src {
  const T* a;
  int lda, ca;
  const T* b;
  int ldb;
  __device__ __forceinline__ float at(int t, int c) const {
    return c < ca ? to_f(a[(long long)t * lda + c]) : to_f(b[(long long)t * ldb + (c - ca)]);
  }
};

template <typename T>
__device__ __forceinline__ Src<T> source(const Args<T>& a, const int* op) {
  return Src<T>{bufp(a, op[F_A_BUF], op[F_A_OFF]), op[F_A_LD], op[F_A_C],
                bufp(a, op[F_B_BUF], op[F_B_OFF]), op[F_B_LD]};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float silu_f(float v) { return __fdividef(v, 1.f + __expf(-v)); }
__device__ __forceinline__ float gelu_f(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }

// ---- one GEMM item: a 64 x 64 output tile, or one K split of it
// k steps of BK channels over all taps, and the split-K factor of a record:
// as many splits as fill the grid, each taking a contiguous range of steps
__device__ __forceinline__ int k_steps(const int* op) {
  return op[F_TAPS] * ((op[F_A_C] + op[F_B_C] + BK - 1) / BK);
}
__device__ __forceinline__ int gemm_tiles(const int* op) {
  return ((op[F_T_OUT] + BM - 1) / BM) * ((op[F_N] + BN - 1) / BN);
}
__device__ __forceinline__ int gemm_splits(const int* op) {
  const int s = (int)gridDim.x / gemm_tiles(op), ks = k_steps(op);
  return s < 1 ? 1 : (s > ks ? ks : s);
}

// c += a b for one m16n8k16 tile: bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 consecutive values of the storage dtype, as loaded (converted later, so
// the load stays in flight across the coefficient staging and the barrier)
template <typename T> struct Raw8;
template <> struct Raw8<float> { float4 lo, hi; };
template <> struct Raw8<__nv_bfloat16> { uint4 q; };

__device__ __forceinline__ void ld8(Raw8<float>& r, const float* p) {
  r.lo = *reinterpret_cast<const float4*>(p);
  r.hi = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void ld8(Raw8<__nv_bfloat16>& r, const __nv_bfloat16* p) {
  r.q = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void ldg8(Raw8<float>& r, const float* p) {
  r.lo = __ldg(reinterpret_cast<const float4*>(p));
  r.hi = __ldg(reinterpret_cast<const float4*>(p + 4));
}
__device__ __forceinline__ void ldg8(Raw8<__nv_bfloat16>& r, const __nv_bfloat16* p) {
  r.q = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void zero8(Raw8<float>& r) { r.lo = r.hi = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero8(Raw8<__nv_bfloat16>& r) { r.q = make_uint4(0u, 0u, 0u, 0u); }
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&f)[8]) {
  f[0] = r.lo.x; f[1] = r.lo.y; f[2] = r.lo.z; f[3] = r.lo.w;
  f[4] = r.hi.x; f[5] = r.hi.y; f[6] = r.hi.z; f[7] = r.hi.w;
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// two B fragments (k 0-7 and 8-15 of a 16 x 8 tile) from a row-major
// [k][n] bf16 tile: lane l < 16 gives the address of row l
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2], const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

template <typename T>
__device__ void gemm_tile(const Args<T>& A, const int* op, int item, GemmSmem& s) {
  const int t_in = op[F_T_IN], t_out = op[F_T_OUT], mode = op[F_MODE], taps = op[F_TAPS];
  const int n = op[F_N], pro = op[F_PRO], silu = op[F_SILU], ss_off = op[F_SS_OFF];
  const int ca = op[F_A_C], cb = op[F_B_C];
  const int cin = ca + cb;
  const Src<T> src = source(A, op);
  const int tiles_n = (n + BN - 1) / BN;
  const int splits = gemm_splits(op), tile = item / splits, split = item % splits;
  const int t0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int csteps = (cin + BK - 1) / BK, nsteps = k_steps(op);
  const int ks0 = (int)((long long)split * nsteps / splits);
  const int ks1 = (int)((long long)(split + 1) * nsteps / splits);
  const float* gamma = A.p + op[F_GAMMA_OFF];
  const float* beta = A.p + op[F_BETA_OFF];
  const T* __restrict__ w = A.w + op[F_W_OFF];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int cg = pro == PRO_GN ? cin / op[F_GROUPS] : 1;
  // bf16 runs the products on the tensor cores (mma.sync m16n8k16): warp w
  // owns the 32 x 32 quarter (wm, wn) of the tile, accumulator (i, j) is
  // element j of the C fragment of m tile i / 4 and n tile i % 4; f32 runs
  // SIMT FMAs, thread (ty, tx) owning rows ty * 8 + i, columns tx * 4 + j
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  const int wm = warp >> 1, wn = warp & 1;
  auto row_of = [&](int i, int j) {
    return kMma ? wm * 32 + (i >> 2) * 16 + (lane >> 2) + 8 * (j >> 1) : ty * TM + i;
  };
  auto col_of = [&](int i, int j) {
    return kMma ? wn * 32 + (i & 3) * 8 + 2 * (lane & 3) + (j & 1) : tx * TN + j;
  };
  const float eps = __int_as_float(op[F_EPS]);

  if (pro == PRO_GN) {
    // group statistics from the per-channel sums the producers accumulated
    // (the groups may straddle the two sources of a concatenation)
    const float* sa = A.stats + op[F_CST_A];
    const float* sb = A.stats + op[F_CST_B];
    const float cnt = (float)t_in * (float)cg;
    for (int g = warp; g < op[F_GROUPS]; g += NT / 32) {
      float sum = 0.f, sq = 0.f;
      for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
        if (c < ca) {
          sum += __ldcg(sa + c);
          sq += __ldcg(sa + ca + c);
        } else {
          sum += __ldcg(sb + c - ca);
          sq += __ldcg(sb + cb + c - ca);
        }
      }
      const float mean = warp_sum(sum) / cnt;
      const float var = fmaxf(warp_sum(sq) / cnt - mean * mean, 0.f);
      if (lane == 0) {
        s.g_mean[g] = mean;
        s.g_rstd[g] = rsqrtf(var + eps);
      }
    }
  } else if (pro == PRO_LN && tid < BM) {
    // row statistics from the per-row sums the producer accumulated
    const float* rs = A.stats + op[F_RST_A];
    const int t = t0 + tid;
    float mean = 0.f, rstd = 0.f;
    if (t < t_in) {
      mean = __ldcg(rs + t) / (float)cin;
      const float var = fmaxf(__ldcg(rs + t_in + t) / (float)cin - mean * mean, 0.f);
      rstd = rsqrtf(var + eps);
    }
    s.ln_mean[tid] = mean;
    s.ln_rstd[tid] = rstd;
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // A tile: unit u = tid + NT q (q < 2) is row u / 4, channels 8 (u % 4) ..
  // + 8 of the step; W tile: unit u is k row u / 8, columns 8 (u % 8) .. + 8.
  // Every channel count is a multiple of 8 (the wrapper checks), so a unit
  // lies in one source and its 8 values are one aligned vector.
  constexpr int UNITS = BM * BK / 8 / NT;
  static_assert(UNITS == BK * BN / 8 / NT, "as many A as W units a thread");
  const int g8 = (tid & 3) * 8;
  for (int ks = ks0; ks < ks1; ++ks) {
    const int tap = ks / csteps, c0 = (ks % csteps) * BK;
    // issue the loads first
    Raw8<T> ra[UNITS], rg[UNITS], rw[UNITS];
    bool ok[UNITS];
#pragma unroll
    for (int q = 0; q < UNITS; ++q) {
      const int m = (tid + NT * q) >> 2, t = t0 + m, c = c0 + g8;
      int r;
      if (mode == MODE_DOWN) {
        r = 2 * t + tap - 1;
      } else if (mode == MODE_UP) {
        const int u = t + tap - 1;
        r = (u >= 0 && u < t_out) ? (u >> 1) : -1;
      } else {
        r = t + tap - (taps >> 1);
      }
      ok[q] = c < cin && t < t_out && r >= 0 && r < t_in;
      zero8(ra[q]);
      zero8(rg[q]);
      if (ok[q]) {
        if (c < ca) {
          const T* row = src.a + (long long)r * src.lda;
          ld8(ra[q], row + c);
          if (pro == PRO_GEGLU) ld8(rg[q], row + c + ca);
        } else {
          ld8(ra[q], src.b + (long long)r * src.ldb + (c - ca));
        }
      }
      const int u = tid + NT * q, wk = u >> 3, wc = c0 + wk, col = n0 + (u & 7) * 8;
      zero8(rw[q]);
      if (wc < cin && col < n) ldg8(rw[q], w + (long long)(tap * cin + wc) * n + col);
    }
    // per-channel prologue coefficients of this step
    if (tid < BK && c0 + tid < cin && (pro == PRO_GN || pro == PRO_LN)) {
      const int c = c0 + tid;
      s.c_gamma[tid] = gamma[c];
      s.c_beta[tid] = beta[c];
      if (pro == PRO_GN) {
        s.c_mean[tid] = s.g_mean[c / cg];
        s.c_rstd[tid] = s.g_rstd[c / cg];
        if (ss_off >= 0) {
          s.c_scale[tid] = rnd<T>(1.f + to_f(A.ss[ss_off + c]));
          s.c_shift[tid] = to_f(A.ss[ss_off + cin + c]);
        }
      }
    }
    __syncthreads();
    // the prologue; rows outside the input stay 0 (the convolution's zero padding)
#pragma unroll
    for (int q = 0; q < UNITS; ++q) {
      const int m = (tid + NT * q) >> 2;
      float v[8];
      unpack8(ra[q], v);
      if (ok[q] && (pro != PRO_NONE || silu)) {
        float gv[8];
        unpack8(rg[q], gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int kk = g8 + e;
          float x = v[e];
          if (pro == PRO_GEGLU) {
            x = rnd<T>(x * rnd<T>(gelu_f(gv[e])));
          } else if (pro == PRO_GN) {
            x = rnd<T>((x - s.c_mean[kk]) * s.c_rstd[kk] * s.c_gamma[kk] + s.c_beta[kk]);
            if (ss_off >= 0) x = rnd<T>(rnd<T>(x * s.c_scale[kk]) + s.c_shift[kk]);
          } else if (pro == PRO_LN) {
            x = rnd<T>((x - s.ln_mean[m]) * s.ln_rstd[m] * s.c_gamma[kk] + s.c_beta[kk]);
          }
          if (silu) x = rnd<T>(silu_f(x));
          v[e] = x;
        }
      }
      if constexpr (kMma) {
        uint4 packed;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        *reinterpret_cast<uint4*>(&s.a16[m][g8]) = packed;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) s.a[g8 + e][m] = v[e];
      }
      const int u = tid + NT * q, wk = u >> 3, j = (u & 7) * 8;
      if constexpr (kMma) {
        *reinterpret_cast<uint4*>(&s.b16[wk][j]) = rw[q].q;
      } else {
        float wv[8];
        unpack8(rw[q], wv);
        *reinterpret_cast<float4*>(&s.b[wk][j]) = make_float4(wv[0], wv[1], wv[2], wv[3]);
        *reinterpret_cast<float4*>(&s.b[wk][j + 4]) = make_float4(wv[4], wv[5], wv[6], wv[7]);
      }
    }
    __syncthreads();
    if constexpr (kMma) {
#pragma unroll
      for (int k16 = 0; k16 < BK; k16 += 16) {
        const int kc = k16 + 2 * (lane & 3);
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + (lane >> 2);
          af[mi][0] = ld_pair(&s.a16[r][kc]);
          af[mi][1] = ld_pair(&s.a16[r + 8][kc]);
          af[mi][2] = ld_pair(&s.a16[r][kc + 8]);
          af[mi][3] = ld_pair(&s.a16[r + 8][kc + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) ldmatrix_x2_trans(bfr[ni], &s.b16[k16 + (lane & 15)][wn * 32 + ni * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi * 4 + ni], af[mi], bfr[ni]);
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][ty * TM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&s.a[k][ty * TM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&s.b[k][tx * TN]);
        const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // split-K: every split stores its partial tile (thread-major, so the
  // stores and loads coalesce) in the record's region; the block that
  // brings the tile's last split sums the splits in order and runs the
  // epilogue
  if (splits > 1) {
    float* part = A.acc + (long long)op[F_ACC] * A.acc_elems;
    float* mine = part + (long long)item * (BM * BN);
    int* cnt = A.cnt + op[F_ACC] * A.cnt_elems + tile;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) __stcg(mine + (i * TN + j) * NT + tid, acc[i][j]);
    __threadfence();
    __syncthreads();
    if (tid == 0) s.last = atomicAdd(cnt, 1) == splits - 1;
    __syncthreads();
    if (!s.last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* pp = part + (long long)(tile * splits + sp) * (BM * BN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += __ldcg(pp + (i * TN + j) * NT + tid);
    }
    if (tid == 0) *cnt = 0;
  }

  // epilogue: bias, round, residual, round; then the per-channel sum and
  // sum of squares of the stored values, for a GroupNorm that reads them
  const float* bias = op[F_BIAS_OFF] >= 0 ? A.p + op[F_BIAS_OFF] : nullptr;
  const T* res = op[F_RES_OFF] >= 0 ? bufp(A, op[F_RES_BUF], op[F_RES_OFF]) : nullptr;
  const int res_ld = op[F_RES_LD], out_ld = op[F_OUT_LD];
  T* out = bufp(A, op[F_OUT_BUF], op[F_OUT_OFF]);
  // this thread's values fall in 8 rows x 4 columns (SIMT) or 4 rows x 8
  // columns (mma); slot r / c below is its row / column index in that set
  constexpr int NR = kMma ? 4 : TM, NC = kMma ? 8 : TN;
  auto rslot = [&](int i, int j) { return kMma ? (i >> 2) * 2 + (j >> 1) : i; };
  auto cslot = [&](int i, int j) { return kMma ? (i & 3) * 2 + (j & 1) : j; };
  float csum[NC], csq[NC], rsum[NR], rsq[NR];
#pragma unroll
  for (int c = 0; c < NC; ++c) csum[c] = csq[c] = 0.f;
#pragma unroll
  for (int r = 0; r < NR; ++r) rsum[r] = rsq[r] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int t = t0 + row_of(i, j), col = n0 + col_of(i, j);
      if (t >= t_out || col >= n) continue;
      float v = rnd<T>(bias != nullptr ? acc[i][j] + bias[col] : acc[i][j]);
      if (res != nullptr) v = rnd<T>(v + to_f(res[(long long)t * res_ld + col]));
      from_f(out[(long long)t * out_ld + col], v);
      csum[cslot(i, j)] += v;
      csq[cslot(i, j)] += v * v;
      rsum[rslot(i, j)] += v;
      rsq[rslot(i, j)] += v * v;
    }
  }
  if (op[F_RST_OUT] >= 0) {
    // per-row sums for a LayerNorm that reads them: reduce over the lanes
    // that share the rows, then one atomic per row and lane group
    float* rs = A.stats + op[F_RST_OUT];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int o = kMma ? 2 : BN / TN / 2; o > 0; o >>= 1) {
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], o);
        rsq[r] += __shfl_xor_sync(0xffffffffu, rsq[r], o);
      }
      const int t = t0 + (kMma ? row_of((r >> 1) * 4, (r & 1) * 2) : row_of(r, 0));
      if ((kMma ? (lane & 3) : tx) == 0 && t < t_out) {
        atomicAdd(rs + t, rsum[r]);
        atomicAdd(rs + t_out + t, rsq[r]);
      }
    }
  }
  if (op[F_CST_OUT] >= 0) {
    // per-channel sums for a GroupNorm that reads them (mma: reduce over
    // the 8 lanes that share a column first)
    float* cs = A.stats + op[F_CST_OUT];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if constexpr (kMma) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          csum[c] += __shfl_xor_sync(0xffffffffu, csum[c], o);
          csq[c] += __shfl_xor_sync(0xffffffffu, csq[c], o);
        }
      }
      const int col = n0 + (kMma ? col_of((c >> 1), c & 1) : col_of(0, c));
      if ((!kMma || lane < 4) && col < n) {
        atomicAdd(cs + col, csum[c]);
        atomicAdd(cs + n + col, csq[c]);
      }
    }
  }
}

// ---- self-attention over q|k|v (T, 3C): one (head, 32 query rows) item.
// Not inlined: the tile routine holds 2 x D floats a thread, and inlined it
// would set the register budget (and spills) of the whole kernel.
template <typename T, int D>
__device__ __noinline__ void attn_call(const T* qkv, T* out, int c, int heads, int t_len, long long ld,
                                       float scale, int h, int tile, float* smem) {
  lds_attn::attention_tile<T, D>(qkv, qkv + c, qkv + 2 * c, out, nullptr, heads, t_len, 0, ld, D, 0, ld, D,
                                 0, ld, D, scale, h, tile, smem);
}

template <typename T>
__device__ void attn_item(const Args<T>& A, const int* op, int item, float* smem) {
  const int t_len = op[F_T_IN], c = op[F_N], heads = op[F_GROUPS], d = c / heads;
  const int q_tiles = (t_len + lds_attn::BQ - 1) / lds_attn::BQ;
  const int h = item / q_tiles, tile = item % q_tiles;
  const T* qkv = bufp(A, op[F_A_BUF], op[F_A_OFF]);
  T* out = bufp(A, op[F_OUT_BUF], op[F_OUT_OFF]);
  const long long ld = op[F_A_LD];
  const float scale = __int_as_float(op[F_EPS]);
  switch (d) {
    case 32: attn_call<T, 32>(qkv, out, c, heads, t_len, ld, scale, h, tile, smem); break;
    case 48: attn_call<T, 48>(qkv, out, c, heads, t_len, ld, scale, h, tile, smem); break;
    case 64: attn_call<T, 64>(qkv, out, c, heads, t_len, ld, scale, h, tile, smem); break;
    default: __trap();  // the wrapper admits only these head dims
  }
}

__device__ __forceinline__ int n_items(const int* op) {
  switch (op[F_KIND]) {
    case KIND_GEMM:
      return gemm_tiles(op) * gemm_splits(op);
    default:
      return op[F_GROUPS] * ((op[F_T_IN] + lds_attn::BQ - 1) / lds_attn::BQ);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) unet_fwd_kernel(Args<T> A) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  // the split-K counters and the channel / row sums start at zero (each
  // tile's last block resets its counter again)
  const long long tid = blockIdx.x * (long long)NT + threadIdx.x, stride = (long long)G * NT;
  for (long long i = tid; i < 2LL * A.cnt_elems; i += stride) A.cnt[i] = 0;
  for (long long i = tid; i < A.stats_elems; i += stride) A.stats[i] = 0.f;
  int phase = 0;
  grid.sync();
  if (A.clock != nullptr && tid == 0) A.clock[phase++] = globaltimer();
  int base = 0;  // items of earlier records in this phase, mod G
  for (int i = 0; i < A.n_ops; ++i) {
    const int* op = A.ops + (long long)i * REC;
    const int kind = op[F_KIND];
    const int items = n_items(op);
    for (int j = ((int)blockIdx.x - base + G) % G; j < items; j += G) {
      if (kind == KIND_GEMM) {
        gemm_tile<T>(A, op, j, *reinterpret_cast<GemmSmem*>(smem));
      } else {
        attn_item<T>(A, op, j, smem);
      }
    }
    base = (base + items) % G;
    if (op[F_SYNC]) {
      grid.sync();
      base = 0;
      if (A.clock != nullptr && tid == 0) A.clock[phase++] = globaltimer();
    }
  }
}

template <typename T>
int launch(const int* ops, int n_ops, const void* w, const float* p, const void* ss, void* ws,
           const void* x, void* y, float* stats, int stats_elems, float* acc, int acc_elems, int* cnt,
           int cnt_elems, unsigned long long* clock, void* stream, int* info) {
  Args<T> a{ops, n_ops, static_cast<const T*>(w), p, static_cast<const T*>(ss), static_cast<T*>(ws),
            static_cast<const T*>(x), static_cast<T*>(y), stats, stats_elems, acc, cnt, acc_elems,
            cnt_elems, clock};
  constexpr size_t smem = smem_bytes();
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(unet_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unet_fwd_kernel<T>, NT, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = sms * (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM);
  // a GEMM record has at most one item a block, each item one partial tile
  if ((long long)acc_elems < (long long)grid * BM * BN) return static_cast<int>(cudaErrorInvalidValue);
  if (info != nullptr) {
    info[0] = grid;
    info[1] = per_sm;
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(unet_fwd_kernel<T>), dim3(grid), dim3(NT),
                                  args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stats, acc and cnt are scratch of stats_elems, 2 * acc_elems and
// 2 * cnt_elems elements; clock (may be null) receives one ns timestamp per
// phase; info (may be null) receives the grid size and the co-resident
// blocks per SM
#define UNET_FWD_ARGS                                                                                \
  const int *ops, int n_ops, const void *w, const float *p, const void *ss, void *ws, const void *x, \
      void *y, float *stats, int stats_elems, float *acc, int acc_elems, int *cnt, int cnt_elems,   \
      unsigned long long *clock, void *stream, int *info
#define UNET_FWD_PASS \
  ops, n_ops, w, p, ss, ws, x, y, stats, stats_elems, acc, acc_elems, cnt, cnt_elems, clock, stream, info

extern "C" int unet_fwd_bf16(UNET_FWD_ARGS) { return launch<__nv_bfloat16>(UNET_FWD_PASS); }

extern "C" int unet_fwd_f32(UNET_FWD_ARGS) { return launch<float>(UNET_FWD_PASS); }
