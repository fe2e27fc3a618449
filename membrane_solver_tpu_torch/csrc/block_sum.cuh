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

#pragma once

#include <cuda_runtime.h>

namespace block_sum {

// Sum over the block in a fixed order; the result is valid in thread 0.
// Every thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ double block_sum(double v, double* s_warp) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kWarps ? s_warp[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();  // s_warp may be written again
  return v;
}

// The grid's total of ``v``: true in thread 0 of the last block to finish,
// with the total in ``*total``; false everywhere else.  Every thread of
// every block must call it, once per launch.
template <int kThreads>
__device__ __forceinline__ bool grid_sum(double v, double* __restrict__ partials,
                                         unsigned int* __restrict__ counter, double* total) {
  __shared__ double s_warp[kThreads / 32];
  __shared__ bool s_last;
  const double block = block_sum<kThreads>(v, s_warp);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block;
    __threadfence();
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  double acc = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) acc += __ldcg(partials + i);
  acc = block_sum<kThreads>(acc, s_warp);
  if (threadIdx.x != 0) return false;
  *counter = 0u;  // ready for the next launch on the stream
  *total = acc;
  return true;
}

}  // namespace block_sum
