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
// Design: a register-tiled f32 product that never writes a distance.  A
// block of 256 threads owns 64 rows of x and one contiguous range of codes;
// it streams (64 codes x 16 dims) codebook tiles and (64 rows x 16 dims) x
// tiles through shared memory, each thread accumulating a 4 x 4 tile of
// dot products in registers, then turns its 16 dot products into distances
// (norms precomputed by the wrapper) and keeps a running (min, argmin) for
// its 4 rows over its codes in ascending order.  The 16 threads that share
// a row reduce their pairs with warp shuffles, comparing (distance, index)
// so the lowest index wins a tie.  So that enough blocks fill the card
// when N is small, the code range is split over gridDim.y blocks; each
// split writes one (min, argmin) per row and a second small kernel merges
// the splits with the same comparison.  Ragged N, K and D are masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of x per block
constexpr int BN = 64;   // codes per shared-memory tile
constexpr int BD = 16;   // dims per shared-memory tile
constexpr int NT = 256;  // threads: 16 (codes) x 16 (rows), 4 x 4 each
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(NT) kmeans_argmin_kernel(
    const float* __restrict__ x, const float* __restrict__ cb, const float* __restrict__ cb_sq,
    float* __restrict__ part_d, int* __restrict__ part_i, int* __restrict__ ids,
    int N, int K, int D, int codes_per_split) {
  __shared__ __align__(16) float xs[BD][BM + 4];
  __shared__ __align__(16) float cs[BD][BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int c_begin = split * codes_per_split;
  const int c_end = min(K, c_begin + codes_per_split);

  float best[4];
  int best_i[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    best[r] = INFINITY;
    best_i[r] = NO_INDEX;
  }

  for (int c0 = c_begin; c0 < c_end; c0 += BN) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int d0 = 0; d0 < D; d0 += BD) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < (BM * BD) / NT; ++u) {
        const int e = tid + NT * u, r = e / BD, dd = e % BD, gd = d0 + dd;
        const int gr = row0 + r, gc = c0 + r;
        xs[dd][r] = (gr < N && gd < D) ? x[(long long)gr * D + gd] : 0.f;
        cs[dd][r] = (gc < c_end && gd < D) ? cb[(long long)gc * D + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < BD; ++dd) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[dd][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[dd][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int code = c0 + tx * 4 + c;
      if (code < c_end) {
        const float csq = cb_sq[code];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dist = csq - 2.f * acc[r][c];
          if (better(dist, code, best[r], best_i[r])) {
            best[r] = dist;
            best_i[r] = code;
          }
        }
      }
    }
  }

  // the 16 threads of a row are one half-warp: reduce their (min, argmin)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[r], off);
      if (better(od, oi, best[r], best_i[r])) {
        best[r] = od;
        best_i[r] = oi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + ty * 4 + r;
      if (row >= N) continue;
      if (gridDim.y == 1) {
        ids[row] = best_i[r] == NO_INDEX ? 0 : best_i[r];
      } else {
        part_d[(long long)split * N + row] = best[r];
        part_i[(long long)split * N + row] = best_i[r];
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
// (splits, N) int32 scratch; codes_per_split is a multiple of 64 with
// splits * codes_per_split >= K.
extern "C" int kmeans_argmin_f32(const float* x, const float* cb, const float* cb_sq, float* part_d,
                                 int* part_i, int* ids, int N, int K, int D, int splits,
                                 int codes_per_split, void* stream) {
  if (codes_per_split % BN != 0 || (long long)splits * codes_per_split < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BM - 1) / BM, splits);
  kmeans_argmin_kernel<<<grid, NT, 0, s>>>(x, cb, cb_sq, part_d, part_i, ids, N, K, D,
                                           codes_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  kmeans_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part_d, part_i, ids, N, splits);
  return static_cast<int>(cudaGetLastError());
}
