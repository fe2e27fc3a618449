// Deterministic sum of one double per thread over a whole grid, in one launch.
//
// Shared by frozen_tilt.cu and tri_kernels.cu.  It takes the place of the
// torch.sum that followed each per-triangle energy kernel: every block
// reduces its threads' values to one partial (a shuffle-down tree in each
// warp, then warp 0 over the warps), writes it to partials[blockIdx.x], and
// counts itself done on an integer counter; the last block to finish adds
// the partials in block order and resets the counter for the next launch.
// Every addition runs in a fixed order, in double, so the total is the same
// bits on every run.  The caller owns partials (one double per block) and
// the counter (one uint32, zeroed once).
//
// The grouped form (grid_sums) carries kM sums through one block at once, a
// block's group of members: each sum takes the same tree and the same
// partial order as grid_sum gives it alone, so each total is the bits of
// its own one-sum launch.

#pragma once

#include <cuda_runtime.h>

namespace block_sum {

// Sum over the block of each of the kM values, each in the same fixed order
// (a shuffle-down tree in each warp, then warp 0 over the warps); the results
// are valid in thread 0.  Every thread of the block must call it.
template <int kThreads, int kM>
__device__ __forceinline__ void block_sums(double (&v)[kM], double* s_warp) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[m] += __shfl_down_sync(0xffffffffu, v[m], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < kM; ++m) s_warp[m * kWarps + warp] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    v[m] = 0.0;
    if (warp == 0) {
      v[m] = lane < kWarps ? s_warp[m * kWarps + lane] : 0.0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v[m] += __shfl_down_sync(0xffffffffu, v[m], off);
    }
  }
  __syncthreads();  // s_warp may be written again
}

// The grid's total of each of the first ``here`` of the kM values: true in
// thread 0 of the last block to finish, with sum m in ``total[m]``; false
// everywhere else.  Sum m's partials lie at partials[m * gridDim.x + block];
// the grid's blocks along x share ``counter``.  Every thread of every block
// must call it, once per launch, with the same ``here``.
template <int kThreads, int kM>
__device__ __forceinline__ bool grid_sums(double (&v)[kM], int here, double* __restrict__ partials,
                                          unsigned int* __restrict__ counter, double (&total)[kM]) {
  __shared__ double s_warp[kM * (kThreads / 32)];
  __shared__ bool s_last;
  block_sums<kThreads, kM>(v, s_warp);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      if (m < here) partials[m * gridDim.x + blockIdx.x] = v[m];
    }
    __threadfence();
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  double acc[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    acc[m] = 0.0;
    if (m < here) {
      for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
        acc[m] += __ldcg(partials + m * gridDim.x + i);
      }
    }
  }
  block_sums<kThreads, kM>(acc, s_warp);
  if (threadIdx.x != 0) return false;
  *counter = 0u;  // ready for the next launch on the stream
#pragma unroll
  for (int m = 0; m < kM; ++m) total[m] = acc[m];
  return true;
}

// The grid's total of ``v``: true in thread 0 of the last block to finish,
// with the total in ``*total``; false everywhere else.  Every thread of
// every block must call it, once per launch.
template <int kThreads>
__device__ __forceinline__ bool grid_sum(double v, double* __restrict__ partials,
                                         unsigned int* __restrict__ counter, double* total) {
  double w[1] = {v};
  double t[1];
  const bool last = grid_sums<kThreads, 1>(w, 1, partials, counter, t);
  if (last) *total = t[0];
  return last;
}

}  // namespace block_sum
