// K6: nearest codebook row for each row of x, argmin over K of
// ||c||^2 - 2 x.c in f32, ties to the lowest index.
//
// Replaces: latent_diffusion_speech_tpu/ops/pallas/kmeans.py, function
// `kmeans_argmin` (kernel `_argmin_kernel`), which streams codebook blocks
// through VMEM with a running (min, argmin) per row in scratch; here the
// diffusion trainer's k-means snap (`EuclideanCodebook.quantize`) runs it.
//
// What bounds it on this card: at the training size (N = 4128 rows,
// K = 4096 codes, D = 1280) it reads 42 MB and does 2 N K D = 43.3 GFLOP
// in f32 FMAs (TF32 would not give the exact argmin the contract asks for),
// so it is bound by the CUDA cores' f32 rate, about 0.65 ms at the
// datasheet's 67 TFLOP/s; the bytes would take 13 us.
//
// Design: a register-tiled f32 SGEMM with the argmin fused into its
// epilogue, so no distance is ever written.  A block of 128 threads owns
// 128 rows of x and one contiguous range of codes, which it walks in tiles
// of 128 codes; each thread accumulates a 16 x 8 tile of dot products
// (rows 32 g + ty * 4 + {0..3} for g < 4, codes tx * 4 + {0..3} and
// 64 + tx * 4 + {0..3}), so a k step costs it 6 16-byte shared loads for
// 128 FMAs (an 8 x 8 tile on 256 threads: 4 for 64, and the shared-memory
// pipe, not the FMA pipe, set the pace).  Both operands go through shared
// memory k-major, 16 dims a stage, in two buffers: the global loads of the
// next stage (16-byte vectors when D % 4 == 0 and the pointers are
// aligned, masked scalars otherwise) are in flight in registers while the
// FMAs of the current stage run, and then go to the other buffer, with one
// barrier a stage.  The stages of all the block's code tiles form one
// stream, so the pipeline does not drain between tiles.  After the last
// stage of a code tile, each thread turns its 128 dot products into
// distances (norms precomputed by the wrapper) and the 16 threads that
// share a row (a half-warp) reduce each row's (min, argmin) with shuffles,
// comparing (distance, index) so the lowest index wins a tie; thread tx of
// the half-warp folds row tx into its running pair, so a thread carries 2
// registers of argmin state, not 32.  So that enough blocks fill the card
// (two per SM, 247 registers a thread), the code range is split over
// gridDim.y blocks; each split writes one (min, argmin) per row and a
// second small kernel merges the splits in order with the same comparison.
// Ragged N, K and D are masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // rows of x per block
constexpr int BN = 128;       // codes per tile
constexpr int BK = 16;        // dims per stage
constexpr int LDS = BM + 4;   // shared row pitch: conflict-free transposing stores, 16-byte rows
constexpr int NT = 128;       // threads: 16 (codes) x 8 (rows), 16 x 8 each
constexpr int RT = 16;        // rows a thread
constexpr int NO_INDEX = 0x7fffffff;
static_assert(BM == BN, "one loader serves both operands");
static_assert(BK == 16 && BM == 2 * (NT / 32) * 16, "the loader's mapping: a warp loads 2 x 16 rows x 16 dims");

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// One stage's share of a (128 rows x 16 dims) tile for this thread: rows
// r and r + 64 of the tile (each valid when below `rows`), dims d0 + q*4
// .. +3 for q in {lane/16, 2 + lane/16}.  A warp covers 16 rows x 32
// contiguous bytes per load, and its transposing stores hit 32 distinct
// banks.
template <bool VEC>
__device__ __forceinline__ void load_stage(const float* __restrict__ src, int r, int rows, int d0, int D,
                                           int lane, float4 (&v)[4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = r + half * 64;
    const float* p = src + (long long)rr * D;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int d = d0 + (2 * u + (lane >> 4)) * 4;
      float4& o = v[2 * half + u];
      if (VEC) {
        o = (rr < rows && d < D) ? __ldg(reinterpret_cast<const float4*>(p + d)) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const bool ok = rr < rows;
        o.x = (ok && d + 0 < D) ? __ldg(p + d + 0) : 0.f;
        o.y = (ok && d + 1 < D) ? __ldg(p + d + 1) : 0.f;
        o.z = (ok && d + 2 < D) ? __ldg(p + d + 2) : 0.f;
        o.w = (ok && d + 3 < D) ? __ldg(p + d + 3) : 0.f;
      }
    }
  }
}

__device__ __forceinline__ void store_stage(float (*s)[LDS], int r, int lane, const float4 (&v)[4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = (2 * u + (lane >> 4)) * 4, rr = r + half * 64;
      s[k + 0][rr] = v[2 * half + u].x;
      s[k + 1][rr] = v[2 * half + u].y;
      s[k + 2][rr] = v[2 * half + u].z;
      s[k + 3][rr] = v[2 * half + u].w;
    }
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2) kmeans_argmin_kernel(
    const float* __restrict__ x, const float* __restrict__ cb, const float* __restrict__ cb_sq,
    float* __restrict__ part_d, int* __restrict__ part_i, int* __restrict__ ids,
    int N, int K, int D, int codes_per_split) {
  __shared__ __align__(16) float xs[2][BK][LDS];
  __shared__ __align__(16) float cs[2][BK][LDS];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31;
  const int lr = (tid >> 5) * 16 + (lane & 15);  // the tile rows this thread loads: lr and lr + 64
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int c_begin = split * codes_per_split;
  const int c_end = min(K, c_begin + codes_per_split);
  const int nd = (D + BK - 1) / BK;
  const int stages = nd * ((c_end - c_begin + BN - 1) / BN);
  const float* xt = x + (long long)row0 * D;

  float best = INFINITY;  // the running (min, argmin) of row tx of this thread's 16
  int best_i = NO_INDEX;
  float acc[RT][8];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  float4 vx[4], vc[4];
  load_stage<VEC>(xt, lr, N - row0, 0, D, lane, vx);
  load_stage<VEC>(cb + (long long)c_begin * D, lr, c_end - c_begin, 0, D, lane, vc);
  store_stage(xs[0], lr, lane, vx);
  store_stage(cs[0], lr, lane, vc);
  __syncthreads();

  for (int s = 0; s < stages; ++s) {
    const int cur = s & 1;
    if (s + 1 < stages) {  // the next stage's loads stay in flight through this stage's FMAs
      const int tile = (s + 1) / nd, d0 = ((s + 1) - tile * nd) * BK, c0 = c_begin + tile * BN;
      load_stage<VEC>(xt, lr, N - row0, d0, D, lane, vx);
      load_stage<VEC>(cb + (long long)c0 * D, lr, c_end - c0, d0, D, lane, vc);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[RT];
#pragma unroll
      for (int g = 0; g < RT / 4; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[cur][k][g * 32 + ty * 4]);
        av[4 * g] = a.x;
        av[4 * g + 1] = a.y;
        av[4 * g + 2] = a.z;
        av[4 * g + 3] = a.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&cs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&cs[cur][k][64 + tx * 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    if (s + 1 < stages) {
      store_stage(xs[cur ^ 1], lr, lane, vx);
      store_stage(cs[cur ^ 1], lr, lane, vc);
    }
    __syncthreads();  // one barrier a stage: the other buffer is full, this one free

    const int tile = s / nd;
    if (s - tile * nd == nd - 1) {  // the code tile's last stage: fold its distances into the running argmin
      const int c0 = c_begin + tile * BN;
      int code[8];
      float csq[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        code[c] = c0 + (c < 4 ? tx * 4 + c : 64 + tx * 4 + c - 4);
        csq[c] = code[c] < c_end ? cb_sq[code[c]] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float bd = INFINITY;
        int bi = NO_INDEX;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float dist = csq[c] - 2.f * acc[r][c];
          if (code[c] < c_end && better(dist, code[c], bd, bi)) {
            bd = dist;
            bi = code[c];
          }
          acc[r][c] = 0.f;
        }
        // the 16 threads of a row are one half-warp: reduce their (min, argmin)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float od = __shfl_xor_sync(0xffffffffu, bd, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (better(od, oi, bd, bi)) {
            bd = od;
            bi = oi;
          }
        }
        if (tx == r && better(bd, bi, best, best_i)) {  // thread tx keeps row tx's running pair
          best = bd;
          best_i = bi;
        }
      }
    }
  }

  {
    const int row = row0 + (tx >> 2) * 32 + ty * 4 + (tx & 3);
    if (row < N) {
      if (gridDim.y == 1) {
        ids[row] = best_i == NO_INDEX ? 0 : best_i;
      } else {
        part_d[(long long)split * N + row] = best;
        part_i[(long long)split * N + row] = best_i;
      }
    }
  }
}

__global__ void kmeans_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                                    int* __restrict__ ids, int N, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float bd = part_d[row];
  int bi = part_i[row];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d[(long long)s * N + row];
    const int i = part_i[(long long)s * N + row];
    if (better(d, i, bd, bi)) {
      bd = d;
      bi = i;
    }
  }
  ids[row] = bi == NO_INDEX ? 0 : bi;
}

}  // namespace

// x (N, D) and codebook (K, D) contiguous f32, cb_sq (K,) f32 row norms;
// ids (N,) int32.  splits > 1 needs part_d (splits, N) f32 and part_i
// (splits, N) int32 scratch; codes_per_split is a multiple of 128 with
// splits * codes_per_split >= K.  vec = 1 asks for the 16-byte loads: D a
// multiple of 4 and both pointers 16-byte aligned.
extern "C" int kmeans_argmin_f32(const float* x, const float* cb, const float* cb_sq, float* part_d,
                                 int* part_i, int* ids, int N, int K, int D, int splits,
                                 int codes_per_split, int vec, void* stream) {
  if (codes_per_split % BN != 0 || (long long)splits * codes_per_split < K ||
      (vec && (D % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(cb) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BM - 1) / BM, splits);
  if (vec)
    kmeans_argmin_kernel<true><<<grid, NT, 0, s>>>(x, cb, cb_sq, part_d, part_i, ids, N, K, D, codes_per_split);
  else
    kmeans_argmin_kernel<false><<<grid, NT, 0, s>>>(x, cb, cb_sq, part_d, part_i, ids, N, K, D, codes_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  kmeans_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part_d, part_i, ids, N, splits);
  return static_cast<int>(cudaGetLastError());
}
