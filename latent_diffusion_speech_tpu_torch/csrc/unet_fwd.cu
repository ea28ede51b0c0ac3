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
// forward.  The kernel is still far from the bound (PERF.md): a forward is
// a chain of 212 short phases at T = 448, each ended by a grid barrier
// (~2.2 us alone), and each phase's time is the latency of a few dependent
// steps (copies, prologue, MMAs, a split-K merge, the epilogue), not bytes
// or tensor-core work.
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
//   ATTN  self-attention over q|k|v.  bf16: K4's tensor-core routine
//         (`lds_mma::attention_fwd_rows`, attention_mma.cuh), one item per
//         (head, 64 query rows), p rounded to bf16 after normalising as in
//         K2; f32: K4's CUDA-core tile (attention_fwd.cuh), one item per
//         (head, 32 query rows).
// Records marked SYNC end a phase with a grid barrier (cooperative_groups
// grid sync); within a phase the records' items are dealt round-robin over
// the blocks.  A GEMM item is a 64 x 64 output tile, or one of its K splits:
// a record with fewer tiles than blocks splits K so that the items fill the
// grid, each split stores its f32 partial tile, and the block that brings
// the last split sums them in order (deterministic) and runs the epilogue.
//
// The GEMM k loop walks the input channels in steps of 128 bytes (64 bf16
// or 32 f32 channels); a step covers all the record's taps.  The input rows
// a tile's taps read (t0 - 1 .. t0 + 64 for a k=3 conv, the 2 t + k - 1
// rows of the stride-2 mode, the (t + k - 1) / 2 rows of the upsampling
// mode) are staged once a step, through the prologue once, and every tap's
// MMAs read row-shifted fragments of that one staged tile against the tap's
// W tile.  The shared tiles are double-buffered, with one barrier a step:
// the next step's A rows and W tiles move by 16-byte cp.async straight into
// the other buffer while the current step's MMAs run, and each thread then
// runs the prologue in place on the A units it copied itself (no barrier
// between its copy and its prologue).  The item's norm coefficients are
// copied to shared memory once, before its first step.  The epilogue puts
// the f32 tile through shared memory, so that its residual loads and output
// stores are 16-byte vectors of 8 consecutive channels.  (The prologue's
// unit loop stays rolled: unrolled, the bodies of every prologue kind
// outgrew the instruction cache of this one kernel that holds every
// layer's code.)  A thread loads 8 consecutive channels of a row as one
// vector, so every channel count must be a multiple of 8.  bf16 multiplies on the tensor
// cores (mma.sync m16n8k16, f32 accumulators; A fragments by ldmatrix from
// any staged row, W fragments by ldmatrix.trans), f32 with SIMT FMAs, 8 x 4
// accumulators a thread.  Values round to the storage dtype where the TPU
// kernel rounds: after every product, every norm and every elementwise
// step.  Activations, skips, statistics and split-K partials live in
// scratch the wrapper allocates; the kernel allocates nothing.

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_fwd.cuh"
#include "attention_mma.cuh"

namespace cg = cooperative_groups;

namespace {

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
static_assert(NT == lds_mma::NT, "both attention routines run on the GEMM's 128 threads");
constexpr int BM = 64, BN = 64;   // GEMM output tile
constexpr int TM = 8, TN = 4;     // f32: accumulators per thread
constexpr int MAX_TAPS = 3;
constexpr int R_MAX = 2 * BM + 1;  // staged input rows of a tile, at most (the stride-2 mode)
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int MAX_GROUPS = 32;
static_assert((BM / TM) * (BN / TN) == NT, "one thread per 8 x 4 sub-tile");

// per storage dtype: a k step is 128 bytes of a row (64 bf16 or 32 f32
// channels); shared rows carry 16 bytes of padding, so the rows that one
// ldmatrix or one 16-byte load phase reads fall in distinct bank groups
template <typename T>
struct Geo {
  static constexpr int BK = 128 / sizeof(T);               // channels a k step
  static constexpr int AP = BK + 16 / sizeof(T);           // staged A row pitch (elements)
  static constexpr int WP = BN + 16 / sizeof(T);           // W row pitch (elements)
  static constexpr int UPR = BK / 8;                       // 8-channel units a staged row
  static constexpr int QA = (R_MAX * UPR + NT - 1) / NT;   // A units a thread a step, at most
  static constexpr int GQ = BM * UPR / NT;                 // GEGLU: units of x (then as many of the gate)
  static_assert(R_MAX >= 2 * BM, "a GEGLU record stages x and its gate");
  static constexpr int WCH = BN * sizeof(T) / 16;          // 16-byte chunks a W row
  static constexpr int QW = BK * WCH / NT;                 // W chunks a thread a tap
  static_assert(NT % UPR == 0 && BK * WCH % NT == 0, "a thread keeps its channels; W chunks divide");
  static_assert(2 * GQ <= QA && BM * UPR % NT == 0, "the GEGLU gate fits in the A units the 64 rows leave");
};

// The k steps' shared tiles, double-buffered: each of the two stages holds
// the staged A rows (after the prologue, row pitch AP) and the W tiles of
// the step's taps (row-major [tap][k][n], pitch WP), laid out for the
// record at hand; the space is two stages of the largest record, the
// stride-2 convolution.
template <typename T>
__host__ __device__ constexpr int stages_elems() {
  return 2 * (R_MAX * Geo<T>::AP + MAX_TAPS * Geo<T>::BK * Geo<T>::WP);
}

constexpr int MAX_NORM_C = 1024;  // channels of a GroupNorm / LayerNorm input, at most

template <typename T>
struct GemmSmem {
  T stages[stages_elems<T>()];
  float c_gamma[MAX_NORM_C];  // the norm's gamma and beta of the item's channels
  float c_beta[MAX_NORM_C];
  T c_scale[MAX_NORM_C];      // the time scale and shift of the item's channels
  T c_shift[MAX_NORM_C];
  float ln_mean[BM];         // LayerNorm: row statistics of the tile
  float ln_rstd[BM];
  float g_mean[MAX_GROUPS];  // GroupNorm: group statistics
  float g_rstd[MAX_GROUPS];
  int last;                  // split-K: this block finishes the tile
};

template <typename T>
constexpr size_t smem_bytes() {
  constexpr size_t attn = std::is_same<T, __nv_bfloat16>::value ? sizeof(lds_mma::Smem<64>)
                                                                  : lds_attn::attention_smem_floats(64) * sizeof(float);
  return sizeof(GemmSmem<T>) > attn ? sizeof(GemmSmem<T>) : attn;
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
// k steps of BK channels (each over all taps), and the split-K factor of a
// record: as many splits as fill the grid, each taking a contiguous range
// of steps
template <typename T>
__device__ __forceinline__ int k_steps(const int* op) {
  return (op[F_A_C] + op[F_B_C] + Geo<T>::BK - 1) / Geo<T>::BK;
}
__device__ __forceinline__ int gemm_tiles(const int* op) {
  return ((op[F_T_OUT] + BM - 1) / BM) * ((op[F_N] + BN - 1) / BN);
}
template <typename T>
__device__ __forceinline__ int gemm_splits(const int* op) {
  const int s = (int)gridDim.x / gemm_tiles(op), ks = k_steps<T>(op);
  return s < 1 ? 1 : (s > ks ? ks : s);
}

// The input rows a tile's taps read, staged once a step: input row
// stage_lo + i is staged row i (rows outside the input stage as 0, the
// convolution's zero padding), and output row t0 + m reads staged row
// stage_row(m, tap) at that tap.
__device__ __forceinline__ int stage_lo(int mode, int taps, int t0) {
  return mode == MODE_DOWN ? 2 * t0 - 1 : (mode == MODE_UP ? ((t0 - 1) >> 1) : t0 - (taps >> 1));
}
__device__ __forceinline__ int stage_rows(int mode, int taps) {
  return mode == MODE_DOWN ? 2 * BM + 1 : (mode == MODE_UP ? BM / 2 + 2 : BM + taps - 1);
}
__device__ __forceinline__ int stage_row(int mode, int t0, int lo, int m, int tap) {
  return mode == MODE_DOWN ? 2 * m + tap : (mode == MODE_UP ? ((t0 + m + tap - 1) >> 1) - lo : m + tap);
}

// c += a b for one m16n8k16 tile: bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 consecutive values of the storage dtype: one 16-byte vector in bf16, two in f32
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
// 8 values rounded to the storage dtype, stored as one 16-byte vector in bf16, two in f32
__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 packed;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = packed;
}
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
__device__ void gemm_tile(const Args<T>& A, const int* op, int item, GemmSmem<T>& s) {
  using G = Geo<T>;
  constexpr int BK = G::BK;
  const int t_in = op[F_T_IN], t_out = op[F_T_OUT], mode = op[F_MODE], taps = op[F_TAPS];
  const int n = op[F_N], pro = op[F_PRO], silu = op[F_SILU], ss_off = op[F_SS_OFF];
  const int ca = op[F_A_C], cb = op[F_B_C];
  const int cin = ca + cb;
  const Src<T> src = source(A, op);
  const int tiles_n = (n + BN - 1) / BN;
  const int splits = gemm_splits<T>(op), tile = item / splits, split = item % splits;
  const int t0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int nsteps = k_steps<T>(op);
  const int ks0 = (int)((long long)split * nsteps / splits);
  const int ks1 = (int)((long long)(split + 1) * nsteps / splits);
  const float* gamma = A.p + op[F_GAMMA_OFF];
  const float* beta = A.p + op[F_BETA_OFF];
  const T* __restrict__ w = A.w + op[F_W_OFF];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int cg = pro == PRO_GN ? cin / op[F_GROUPS] : 1;
  const int lo = stage_lo(mode, taps, t0), rows = stage_rows(mode, taps);
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

  // the item's channels' coefficients into shared memory, once (the wrapper
  // holds every normalised input to MAX_NORM_C channels)
  const int c_lo = ks0 * BK, c_hi = min(ks1 * BK, cin);
  if (pro == PRO_GN || pro == PRO_LN) {
    for (int c = c_lo + 4 * tid; c < c_hi; c += 4 * NT) {
      lds_mma::cp_async16(&s.c_gamma[c - c_lo], gamma + c, true);
      lds_mma::cp_async16(&s.c_beta[c - c_lo], beta + c, true);
    }
    constexpr int V = 16 / sizeof(T);
    if (pro == PRO_GN && ss_off >= 0) {
      for (int c = c_lo + V * tid; c < c_hi; c += V * NT) {
        lds_mma::cp_async16(&s.c_scale[c - c_lo], A.ss + ss_off + c, true);
        lds_mma::cp_async16(&s.c_shift[c - c_lo], A.ss + ss_off + cin + c, true);
      }
    }
  }
  lds_mma::cp_async_commit();

  if (pro == PRO_GN) {
    // group statistics from the per-channel sums the producers accumulated
    // (the groups may straddle the two sources of a concatenation); warp w
    // takes groups w, w + 4, ..., every lane's first channel of each loaded
    // at once, so the loads of all its groups are in flight together
    constexpr int GW = MAX_GROUPS / (NT / 32);
    const float* sa = A.stats + op[F_CST_A];
    const float* sb = A.stats + op[F_CST_B];
    const float cnt = (float)t_in * (float)cg;
    auto add = [&](int c, float& sum, float& sq) {
      if (c < ca) {
        sum += __ldcg(sa + c);
        sq += __ldcg(sa + ca + c);
      } else {
        sum += __ldcg(sb + c - ca);
        sq += __ldcg(sb + cb + c - ca);
      }
    };
    float sum[GW], sq[GW];
#pragma unroll
    for (int k = 0; k < GW; ++k) {
      const int g = warp + k * (NT / 32);
      sum[k] = sq[k] = 0.f;
      if (g < op[F_GROUPS] && lane < cg) add(g * cg + lane, sum[k], sq[k]);
    }
#pragma unroll
    for (int k = 0; k < GW; ++k) {
      const int g = warp + k * (NT / 32);
      if (g >= op[F_GROUPS]) break;  // warp-uniform
      for (int c = g * cg + 32 + lane; c < (g + 1) * cg; c += 32) add(c, sum[k], sq[k]);
      const float mean = warp_sum(sum[k]) / cnt;
      const float var = fmaxf(warp_sum(sq[k]) / cnt - mean * mean, 0.f);
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
  lds_mma::cp_async_wait<0>();
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // A: unit u = tid + NT q is staged row u / UPR, channels 8 (u % UPR) .. + 8
  // of the step, so a thread keeps the same 8 channels in every unit; every
  // channel count is a multiple of 8 (the wrapper checks), so a unit lies in
  // one source and its 8 values are one aligned vector.  A GEGLU record
  // stages its 64 rows of x in staged rows 0-63 and their gate in 64-127
  // (units GQ.. 2 GQ - 1 of the same thread).  W: chunk u of a tap is k row
  // u / WCH, 16 bytes at column (u % WCH) * 16 / sizeof(T).
  const int g8 = (tid % G::UPR) * 8;
  const int units = pro == PRO_GEGLU ? 2 * G::GQ : G::QA;
  const int a_rows = pro == PRO_GEGLU ? 2 * BM : rows;         // staged rows of a stage
  const int stage_elems = a_rows * G::AP + taps * BK * G::WP;  // one of the two stages
  auto a_at = [&](int st, int row) { return s.stages + st * stage_elems + row * G::AP; };
  auto w_at = [&](int st, int tap, int k) {
    return s.stages + st * stage_elems + a_rows * G::AP + (tap * BK + k) * G::WP;
  };
  // the input row that unit q stages at channel c, or -1 when it stages as 0
  auto in_row = [&](int q, int c) {
    const int sr = (tid + NT * q) / G::UPR;
    const int r = lo + (pro == PRO_GEGLU && q >= G::GQ ? sr - BM : sr);
    return sr < a_rows && c < cin && r >= 0 && r < t_in ? r : -1;
  };
  // step ks's A rows and W tiles by cp.async into stage st (rows outside
  // the input fill with 0, the convolution's zero padding)
  auto issue = [&](int ks, int st) {
    const int c0 = ks * BK, c = c0 + g8;
#pragma unroll
    for (int q = 0; q < G::QA; ++q) {
      const int sr = (tid + NT * q) / G::UPR;
      if (q >= units || sr >= a_rows) break;
      const int r = in_row(q, c);
      const T* from = src.a;
      if (r >= 0) {
        from = c < ca ? src.a + (long long)r * src.lda + c + (q >= G::GQ && pro == PRO_GEGLU ? ca : 0)
                      : src.b + (long long)r * src.ldb + (c - ca);
      }
#pragma unroll
      for (int h = 0; h < (int)sizeof(T) / 2; ++h)  // 8 values: one 16-byte copy in bf16, two in f32
        lds_mma::cp_async16(a_at(st, sr) + g8 + h * 4, from + h * 4, r >= 0);
    }
    for (int tap = 0; tap < taps; ++tap) {
#pragma unroll
      for (int q = 0; q < G::QW; ++q) {
        const int u = tid + NT * q, k = u / G::WCH, col = (u % G::WCH) * (16 / (int)sizeof(T));
        const bool ok = c0 + k < cin && n0 + col < n;
        lds_mma::cp_async16(w_at(st, tap, k) + col, ok ? w + (long long)(tap * cin + c0 + k) * n + n0 + col : w,
                            ok);
      }
    }
    lds_mma::cp_async_commit();
  };
  // the prologue of step ks, in place on the thread's own staged units of
  // stage st (its own copies have landed); rows outside the input stay 0
  auto stage = [&](int ks, int st) {
    const int c = ks * BK + g8;
    if ((pro == PRO_NONE && !silu) || c >= cin) return;
    float mean[8], rstd[8];  // GroupNorm: the statistics of each channel's group
    if (pro == PRO_GN) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        mean[e] = s.g_mean[(c + e) / cg];
        rstd[e] = s.g_rstd[(c + e) / cg];
      }
    }
    float gm[8], bt[8], sc[8], sh[8];
    if (pro == PRO_GN || pro == PRO_LN) {
      unpack8(Raw8<float>{*reinterpret_cast<const float4*>(&s.c_gamma[c - c_lo]),
                          *reinterpret_cast<const float4*>(&s.c_gamma[c - c_lo + 4])}, gm);
      unpack8(Raw8<float>{*reinterpret_cast<const float4*>(&s.c_beta[c - c_lo]),
                          *reinterpret_cast<const float4*>(&s.c_beta[c - c_lo + 4])}, bt);
    }
    if (pro == PRO_GN && ss_off >= 0) {
      Raw8<T> r;
      ld8(r, &s.c_scale[c - c_lo]);
      unpack8(r, sc);
      ld8(r, &s.c_shift[c - c_lo]);
      unpack8(r, sh);
#pragma unroll
      for (int e = 0; e < 8; ++e) sc[e] = rnd<T>(1.f + sc[e]);
    }
    // one unit per trip, not unrolled: the unrolled bodies of every
    // prologue kind would outgrow the instruction cache
#pragma unroll 1
    for (int q = 0; q < G::QA; ++q) {
      const int sr = (tid + NT * q) / G::UPR;
      if (sr >= rows) break;
      if (in_row(q, c) < 0) continue;
      T* at = a_at(st, sr) + g8;
      Raw8<T> raw;
      ld8(raw, at);
      float v[8];
      unpack8(raw, v);
      if (pro == PRO_GEGLU) {
        float gv[8];
        ld8(raw, at + BM * G::AP);
        unpack8(raw, gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = rnd<T>(v[e] * rnd<T>(gelu_f(gv[e])));
      } else if (pro == PRO_GN) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = rnd<T>((v[e] - mean[e]) * rstd[e] * gm[e] + bt[e]);
        if (ss_off >= 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rnd<T>(rnd<T>(v[e] * sc[e]) + sh[e]);
        }
      } else if (pro == PRO_LN) {
        const float m = s.ln_mean[sr], r = s.ln_rstd[sr];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = rnd<T>((v[e] - m) * r * gm[e] + bt[e]);
      }
      if (silu) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = rnd<T>(silu_f(v[e]));
      }
      st8(at, v);
    }
  };

  issue(ks0, 0);
  for (int ks = ks0; ks < ks1; ++ks) {
    const int st = (ks - ks0) & 1;
    lds_mma::cp_async_wait<0>();  // this thread's copies of step ks have landed
    stage(ks, st);
    // one barrier a step: stage st is complete, and every thread is done
    // with the other, which the next step's copies fill during these MMAs
    __syncthreads();
    if (ks + 1 < ks1) issue(ks + 1, st ^ 1);
    for (int tap = 0; tap < taps; ++tap) {
      if constexpr (kMma) {
        const __nv_bfloat16* ap[2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ap[mi] = a_at(st, stage_row(mode, t0, lo, wm * 32 + mi * 16 + (lane & 15), tap)) + (lane >> 4) * 8;
#pragma unroll
        for (int k16 = 0; k16 < BK; k16 += 16) {
          uint32_t af[2][4], bfr[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) lds_mma::ldmatrix_x4(af[mi], ap[mi] + k16);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            ldmatrix_x2_trans(bfr[ni], w_at(st, tap, k16 + (lane & 15)) + wn * 32 + ni * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi * 4 + ni], af[mi], bfr[ni]);
        }
      } else {
        const float* ar[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) ar[i] = a_at(st, stage_row(mode, t0, lo, ty * TM + i, tap));
#pragma unroll 2
        for (int k4 = 0; k4 < BK; k4 += 4) {
          float av[TM][4];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float4 a4 = *reinterpret_cast<const float4*>(ar[i] + k4);
            av[i][0] = a4.x;
            av[i][1] = a4.y;
            av[i][2] = a4.z;
            av[i][3] = a4.w;
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 b4 = *reinterpret_cast<const float4*>(w_at(st, tap, k4 + kk) + tx * TN);
            const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();  // the shared tiles are free for the epilogue and the block's next item

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
#pragma unroll 2
    for (int sp = 0; sp < splits; ++sp) {
      const float* pp = part + (long long)(tile * splits + sp) * (BM * BN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += __ldcg(pp + (i * TN + j) * NT + tid);
    }
    if (tid == 0) *cnt = 0;
  }

  // epilogue: bias, round, residual, round; then the per-channel (GroupNorm)
  // or per-row (LayerNorm) sum and sum of squares of the stored values, for
  // the record that normalises them.  The f32 tile goes through shared
  // memory (the stages are free), so that a thread then owns chunks of 8
  // consecutive columns: 16-byte residual loads and output stores, and the
  // thread's 8 columns the same in all its chunks (u = tid + NT q: row
  // u / 8, columns 8 (u % 8) .. + 8).
  constexpr int TP = BN + 4;  // f32 tile pitch
  static_assert(BM * TP * sizeof(float) <= stages_elems<T>() * sizeof(T), "the tile fits in the stages");
  static_assert(BM * BN / 8 % NT == 0 && NT % 8 == 0, "whole chunks a thread, one column group");
  constexpr int QC = BM * BN / 8 / NT;  // chunks a thread
  float* tile_s = reinterpret_cast<float*>(s.stages);
  const float* bias = op[F_BIAS_OFF] >= 0 ? A.p + op[F_BIAS_OFF] : nullptr;
  const T* res = op[F_RES_OFF] >= 0 ? bufp(A, op[F_RES_BUF], op[F_RES_OFF]) : nullptr;
  const int res_ld = op[F_RES_LD], out_ld = op[F_OUT_LD];
  T* out = bufp(A, op[F_OUT_BUF], op[F_OUT_OFF]);
  const int c8 = (tid % 8) * 8, col = n0 + c8;  // n is a multiple of 8: a chunk is all in or all out
  // the bias and the residuals first, in flight while the tile goes through
  // shared memory (a load after an output store, which might alias it,
  // would wait out its own round trip)
  float bv[8];
  if (bias != nullptr && col < n) {
    unpack8(Raw8<float>{__ldg(reinterpret_cast<const float4*>(bias + col)),
                        __ldg(reinterpret_cast<const float4*>(bias + col) + 1)}, bv);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) bv[e] = 0.f;
  }
  Raw8<T> rv[QC];
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    const int t = t0 + (tid + NT * q) / 8;
    if (res != nullptr && t < t_out && col < n) ld8(rv[q], res + (long long)t * res_ld + col);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) tile_s[row_of(i, j) * TP + col_of(i, j)] = acc[i][j];
  __syncthreads();
  float csum[8], csq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) csum[e] = csq[e] = 0.f;
  float* rs = op[F_RST_OUT] >= 0 ? A.stats + op[F_RST_OUT] : nullptr;
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    const int m = (tid + NT * q) / 8, t = t0 + m;
    float rsum = 0.f, rsq = 0.f;
    if (t < t_out && col < n) {
      float v[8], r[8];
      const float4 lo = *reinterpret_cast<const float4*>(&tile_s[m * TP + c8]);
      const float4 hi = *reinterpret_cast<const float4*>(&tile_s[m * TP + c8 + 4]);
      unpack8(Raw8<float>{lo, hi}, v);
      if (res != nullptr) unpack8(rv[q], r);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = rnd<T>(v[e] + bv[e]);
        if (res != nullptr) v[e] = rnd<T>(v[e] + r[e]);
        csum[e] += v[e];
        csq[e] += v[e] * v[e];
        rsum += v[e];
        rsq += v[e] * v[e];
      }
      st8(out + (long long)t * out_ld + col, v);
    }
    if (rs != nullptr) {
      // the row's 8 chunks are 8 neighbouring lanes: one atomic per row
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
        rsq += __shfl_xor_sync(0xffffffffu, rsq, o);
      }
      if (tid % 8 == 0 && t < t_out) {
        atomicAdd(rs + t, rsum);
        atomicAdd(rs + t_out + t, rsq);
      }
    }
  }
  if (op[F_CST_OUT] >= 0) {
    // per-channel sums: the warp's lanes with the same column group first
    float* cs = A.stats + op[F_CST_OUT];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int o = 8; o < 32; o <<= 1) {
        csum[e] += __shfl_xor_sync(0xffffffffu, csum[e], o);
        csq[e] += __shfl_xor_sync(0xffffffffu, csq[e], o);
      }
    }
    if (lane < 8 && col < n) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        atomicAdd(cs + col + e, csum[e]);
        atomicAdd(cs + n + col + e, csq[e]);
      }
    }
  }
  __syncthreads();  // the tile's shared memory is free for the block's next item
}

// ---- self-attention over q|k|v (T, 3C) into out (T, C): one (head, query
// tile) item, 64 rows on the tensor cores (bf16) or 32 on the CUDA cores
// (f32).  Not inlined: each routine holds its row state in registers, and
// inlined it would set the register budget (and spills) of the whole kernel.
template <int D>
__device__ __noinline__ void attn_call(const __nv_bfloat16* qkv, __nv_bfloat16* out, int c, int t_len,
                                       long long ld, long long ld_out, float scale, int h, int tile,
                                       float* smem) {
  const __nv_bfloat16* q = qkv + h * D;
  lds_mma::attention_fwd_rows<D>(q, q + c, q + 2 * c, ld, ld, ld, out + h * D, ld_out, nullptr, t_len, scale, tile,
                                 *reinterpret_cast<lds_mma::Smem<D>*>(smem));
}
template <int D>
__device__ __noinline__ void attn_call(const float* qkv, float* out, int c, int t_len, long long ld,
                                       long long ld_out, float scale, int h, int tile, float* smem) {
  lds_attn::attention_tile<float, D>(qkv, qkv + c, qkv + 2 * c, out, nullptr, c / D, t_len, 0, ld, D, 0, ld, D,
                                     0, ld, D, scale, h, tile, smem);
}

template <typename T>
__device__ __forceinline__ int attn_rows() {
  return std::is_same<T, __nv_bfloat16>::value ? lds_mma::BM : lds_attn::BQ;
}

template <typename T>
__device__ void attn_item(const Args<T>& A, const int* op, int item, float* smem) {
  const int t_len = op[F_T_IN], c = op[F_N], heads = op[F_GROUPS], d = c / heads;
  const int q_tiles = (t_len + attn_rows<T>() - 1) / attn_rows<T>();
  const int h = item / q_tiles, tile = item % q_tiles;
  const T* qkv = bufp(A, op[F_A_BUF], op[F_A_OFF]);
  T* out = bufp(A, op[F_OUT_BUF], op[F_OUT_OFF]);
  const long long ld = op[F_A_LD], ld_out = op[F_OUT_LD];
  const float scale = __int_as_float(op[F_EPS]);
  switch (d) {
    case 32: attn_call<32>(qkv, out, c, t_len, ld, ld_out, scale, h, tile, smem); break;
    case 48: attn_call<48>(qkv, out, c, t_len, ld, ld_out, scale, h, tile, smem); break;
    case 64: attn_call<64>(qkv, out, c, t_len, ld, ld_out, scale, h, tile, smem); break;
    default: __trap();  // the wrapper admits only these head dims
  }
}

template <typename T>
__device__ __forceinline__ int n_items(const int* op) {
  switch (op[F_KIND]) {
    case KIND_GEMM:
      return gemm_tiles(op) * gemm_splits<T>(op);
    default:
      return op[F_GROUPS] * ((op[F_T_IN] + attn_rows<T>() - 1) / attn_rows<T>());
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
    const int items = n_items<T>(op);
    for (int j = ((int)blockIdx.x - base + G) % G; j < items; j += G) {
      if (kind == KIND_GEMM) {
        gemm_tile<T>(A, op, j, *reinterpret_cast<GemmSmem<T>*>(smem));
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
  constexpr size_t smem = smem_bytes<T>();
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
