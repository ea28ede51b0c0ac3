// Tensor-core tile toolkit for the bf16 attention kernels: K5
// (`flash_attention.cu`, entry flash_attention_bf16) and the K4 forward
// (`attention_fwd.cu`, entry attention_fwd_bf16, whose body
// `attention_fwd_rows` the fused UNet kernel `unet_fwd.cu` also runs).
//
// Layout.  A block of 4 warps covers BM = 64 query rows; warp w owns rows
// [16w, 16w + 16) of the block over every key, so warps never merge partial
// results.  (Blocks of one warp, 16 rows, were never faster on the H100, not
// even where 64-row blocks leave most multiprocessors idle: the same warps
// then each stream their own K/V tiles.)  Keys stream through shared memory in BK = 64-key K/V
// tiles that stay bf16, each row padded by 8 elements (16 bytes): the 8 rows
// one ldmatrix phase reads then start in 8 distinct 16-byte bank groups (row
// strides of 80, 112 and 144 bytes for D = 32, 48, 64).  Tiles arrive by
// 16-byte cp.async copies, double-buffered, so tile j + 1 loads while tile j
// computes; the kernels issue them through `load_rows`.
//
// Arithmetic.  mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32.
// - S = Q K^T: Q's A fragments come from ldmatrix once per block; each
//   64-key tile is 8 n-tiles of 8 keys, their B fragments from ldmatrix on
//   the K rows (a K row is a column of K^T, the "col" B layout).  A thread
//   holds s[n][0..1] at row g = lane / 4, keys 8n + 2(lane % 4) + {0, 1},
//   and s[n][2..3] at row g + 8, the same keys.
// - O += P V: the f32 C fragments of two neighbouring S n-tiles are, element
//   for element, the A fragment of one 16-key k-step of P V
//   (FlashAttention-2's register reuse), so P never leaves registers; V's B
//   fragments come from ldmatrix.trans on the V rows.
// - Row statistics: a row's 64 scores of a tile lie in the 4 threads of a
//   quad (lanes 4g..4g+3), reduced with two xor shuffles.
// - Scores are taken in log2 units (s * scale * log2(e)), so that every
//   exponential is one exp2f; masked scores are -inf and give p = 0.
//
// Every pointer and every b/t/h stride must be 16-byte aligned (cp.async);
// the Python wrappers check it and raise.  D is a template parameter: 32,
// 48 or 64 (a multiple of 16, the MMA's k depth), or 8.  At D = 8 a
// shared-memory row is 16 wide, its upper 8 columns zero-filled by the
// copies (`load_rows`), so Q K^T runs one 16-deep k-step to which the zeros
// add nothing, and P V is one 8-wide n-tile (`pv_step`).  That wastes half
// of each Q K^T MMA; a 16-wide row keeps the ldmatrix layout of the others.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace lds_mma {

constexpr int WARPS = 4;          // warps per block
constexpr int NT = 32 * WARPS;    // threads per block
constexpr int BM = 16 * WARPS;    // query rows per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int PAD = 8;            // bf16 elements of padding per shared-memory row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Dims {
  static_assert(D == 8 || D % 16 == 0, "the head dim must be 8 or a multiple of 16");
  static constexpr int DK = D < 16 ? 16 : D;  // columns a shared-memory row holds (D = 8: 8 zeros after)
  static constexpr int DP = DK + PAD;  // shared-memory row stride (elements)
  static constexpr int KD = DK / 16;   // k-steps of Q K^T
  static constexpr int ND = D / 8;     // 8-wide n-tiles of the output
};

// shared memory of a block: the Q tile and two K and two V tiles
template <int D>
struct Smem {
  __nv_bfloat16 q[BM * Dims<D>::DP];
  __nv_bfloat16 k[2][BK * Dims<D>::DP];
  __nv_bfloat16 v[2][BK * Dims<D>::DP];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with full = false the destination is zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
// two 8 x 8 matrices, transposed; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even); x in the low
// half, which holds the lower column of a fragment
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x ~ hi + lo with hi = bf16(x) and lo = bf16(x - hi): about 16 significant
// bits, so an f32 p times a bf16 v through two MMAs into one f32 accumulator
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// cp.async rows [r0, r0 + ROWS) of one (batch, head) of a (.., T, .., D)
// tensor (`base` at row 0, row stride `st` elements) into shared memory
// [ROWS][DP]; rows at or past T are zero-filled (so padded keys hold v = 0
// and padded queries q = 0), and so are the columns [D, DK) of every row.
// All NT threads of the block call it.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* base, long long st,
                                          int r0, int T) {
  constexpr int CH = D / 8;               // 16-byte chunks of data a row
  constexpr int CP = Dims<D>::DK / 8;     // 16-byte chunks a shared-memory row holds
#pragma unroll
  for (int it = 0; it < (ROWS * CP + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (ROWS * CP % NT != 0 && i >= ROWS * CP) break;
    const int r = i / CP, c = i % CP;
    const bool ok = r0 + r < T && c < CH;
    cp_async16(dst + r * Dims<D>::DP + c * 8, base + (ok ? (long long)(r0 + r) * st + c * 8 : 0), ok);
  }
}

// the A fragments of a warp's 16 query rows (`qs` at the warp's first row)
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[Dims<D>::KD][4], const __nv_bfloat16* qs, int lane) {
#pragma unroll
  for (int kk = 0; kk < Dims<D>::KD; ++kk)
    ldmatrix_x4(qf[kk], qs + (lane & 15) * Dims<D>::DP + kk * 16 + (lane >> 4) * 8);
}

// s = q . k (f32 sums of exact bf16 products) for the warp's 16 rows and the
// 64 keys of the tile `ks`
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const uint32_t (&qf)[Dims<D>::KD][4],
                                        const __nv_bfloat16* ks, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const int key = (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < Dims<D>::KD; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // two n-tiles (16 keys) an ldmatrix
      uint32_t b[4];
      ldmatrix_x4(b, ks + (np * 16 + key) * Dims<D>::DP + kk * 16 + col);
      mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }
}

// s -> s * scale_log2, with -inf where key >= kv_len or, if causal, key >
// row (top-left aligned); key0 is the tile's first key, row0 the row of the
// thread's first fragment row (g).  `edge` is false when the tile has no
// masked score for any row of the warp, and then only the scale applies.
__device__ __forceinline__ void scale_mask(float (&s)[8][4], float scale_log2, bool edge, int key0,
                                           int kv_len, int row0, bool causal, int lane) {
  if (!edge) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    return;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + n * 8 + 2 * (lane & 3) + (e & 1), row = row0 + (e >> 1) * 8;
      s[n][e] = key < kv_len && (!causal || key <= row) ? s[n][e] * scale_log2 : -INFINITY;
    }
}

// acc (the warp's 16 rows x D, f32) += P V over the 16 keys [16j, 16j + 16)
// of the tile `vs`, for each of the NP A fragments `pa` (one: a rounded p;
// two: the hi and lo parts of an f32 p)
template <int D, int NP>
__device__ __forceinline__ void pv_step(float (&acc)[Dims<D>::ND][4], const uint32_t (&pa)[NP][4],
                                        const __nv_bfloat16* vs, int j, int lane) {
  const int key = 16 * j + (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < Dims<D>::ND / 2; ++dp) {  // two n-tiles (16 columns) an ldmatrix
    uint32_t b[4];
    ldmatrix_x4_trans(b, vs + key * Dims<D>::DP + dp * 16 + col);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      mma_bf16(acc[2 * dp], pa[i], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], pa[i], b[2], b[3]);
    }
  }
  if constexpr (Dims<D>::ND % 2 != 0) {  // D = 8: one n-tile, keys [16j, 16j + 8) and [16j + 8, 16j + 16)
    uint32_t b[2];
    ldmatrix_x2_trans(b, vs + key * Dims<D>::DP + (Dims<D>::ND - 1) * 8);
#pragma unroll
    for (int i = 0; i < NP; ++i) mma_bf16(acc[Dims<D>::ND - 1], pa[i], b[0], b[1]);
  }
}

// store the warp's 16 x D rows o[.][.] / den[r] (r = 0: row g, r = 1: row
// g + 8) as bf16 to out rows row0 (+8), row stride `ld` elements, rows at or
// past T skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld, const float (&o)[Dims<D>::ND][4],
                                           const float (&den)[2], int row0, int T, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= T) continue;
    __nv_bfloat16* p = out + (long long)row * ld + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < Dims<D>::ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] / den[r], o[n][2 * r + 1] / den[r]);
  }
}

// The K4 forward's two passes for one (batch, head) and the 64 query rows
// [64 q_tile, 64 q_tile + 64), by the block's NT threads: q, k, v at the
// head's row 0 with row strides sqt, skt, svt; out at the head's row 0 with
// row stride ld_out; lse (the head's T_len f32, may be null) receives
// m + log l of each row.  Pass 1 walks the K tiles for each row's running
// (max, sum); pass 2 walks the K and V tiles again, recomputes S bit for
// bit and multiplies p = exp(s - m) / l, rounded to bf16, by V.  The two
// passes are one stream of double-buffered tiles.  Ends with a barrier
// after its last use of `sm`.
template <int D>
__device__ __forceinline__ void attention_fwd_rows(const __nv_bfloat16* qb, const __nv_bfloat16* kb,
                                                   const __nv_bfloat16* vb, long long sqt, long long skt,
                                                   long long svt, __nv_bfloat16* ob, long long ld_out,
                                                   float* lse, int T_len, float scale, int q_tile,
                                                   Smem<D>& sm) {
  using Dm = Dims<D>;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wrow = q_tile * BM + 16 * w;  // the warp's first row
  const int row0 = wrow + (lane >> 2);    // this thread's first fragment row
  const bool live = wrow < T_len;
  const int n = (T_len + BK - 1) / BK;  // tiles a pass; steps [0, n) are pass 1, [n, 2n) pass 2

  load_rows<D, BM>(sm.q, qb, sqt, q_tile * BM, T_len);
  cp_async_commit();
  load_rows<D, BK>(sm.k[0], kb, skt, 0, T_len);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[Dm::KD][4];
  load_q<D>(qf, sm.q + 16 * w * Dm::DP, lane);

  // pass 1: this thread's running (max, sum) over its columns, rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  float acc[Dm::ND][4];
#pragma unroll
  for (int i = 0; i < Dm::ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int step = 0; step < 2 * n; ++step) {
    if (step + 1 < 2 * n) {
      const int next = step + 1, tile = next < n ? next : next - n;
      load_rows<D, BK>(sm.k[next & 1], kb, skt, tile * BK, T_len);
      if (next >= n) load_rows<D, BK>(sm.v[next & 1], vb, svt, tile * BK, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (step == n) {
      // merge the quad's partial statistics into the row's m (log2 units)
      // and l; a thread that saw no unmasked key (l = 0) adds nothing
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_row = quad_max(m[r]);
        const float l_row = quad_sum(l[r] > 0.f ? l[r] * exp2f(m[r] - m_row) : 0.f);
        const int row = row0 + 8 * r;
        if (lse != nullptr && (lane & 3) == 0 && row < T_len) lse[row] = (m_row + log2f(l_row)) * LN2;
        m[r] = m_row;
        inv_l[r] = 1.f / l_row;
      }
    }
    const int key0 = (step < n ? step : step - n) * BK;
    if (live) {  // warp-uniform
      float s[8][4];
      qk_tile<D>(s, qf, sm.k[step & 1], lane);
      scale_mask(s, scale_log2, key0 + BK > T_len, key0, T_len, row0, false, lane);
      if (step < n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
          const float m_new = fmaxf(m[r], mx);
          const float m_use = m_new == -INFINITY ? 0.f : m_new;  // every column so far masked
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) sum += exp2f(s[i][2 * r] - m_use) + exp2f(s[i][2 * r + 1] - m_use);
          l[r] = l[r] * exp2f(m[r] - m_use) + sum;
          m[r] = m_new;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // 16 keys a k-step; steps past T skipped
          if (key0 + 16 * j >= T_len) break;
          uint32_t pa[1][4];
#pragma unroll
          for (int half = 0; half < 2; ++half)  // n-tiles 2j and 2j + 1
#pragma unroll
            for (int r = 0; r < 2; ++r)
              pa[0][2 * half + r] = pack_bf16(exp2f(s[2 * j + half][2 * r] - m[r]) * inv_l[r],
                                              exp2f(s[2 * j + half][2 * r + 1] - m[r]) * inv_l[r]);
          pv_step<D, 1>(acc, pa, sm.v[step & 1], j, lane);
        }
      }
    }
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  if (live) store_rows<D>(ob, ld_out, acc, one, row0, T_len, lane);
}

}  // namespace lds_mma
