// Deterministic sum of per-corner rows into per-vertex rows, one thread per vertex.
//
// Shared by frozen_tilt.cu, tri_kernels.cu and vertex_sum.cu.  It takes the
// place of the index_add scatter that followed each per-triangle kernel (the
// JAX package's segment sums in device/geo.py, scatter_add_rows): where
// index_add adds with float atomics in an order that changes from run to
// run, each thread here walks its vertex's corner slots in a fixed order, so
// the sums are the same bits on every run.
//
// The vertex-to-corner map is a CSR built once per topology
// (device/state.corner_csr): slots[offsets[v] .. offsets[v+1]) hold
// tri * 3 + corner for every corner of vertex v, corner-major (corner 0 of
// each triangle in triangle order, then corners 1 and 2).  A source
// array holds one row of W values per corner slot, (T, 3, W) row-major, and
// the output one row per vertex, (N, W).  Two sources go through one launch
// (Wb = 0 for one).  The weighted form (launch_weighted) scales each corner
// row by a per-triangle weight, zero where a per-triangle mask is false, as
// it adds it: one launch where a scale pass and a sum would take two.
//
// What bounds it on an H100: bytes.  A thread reads its slot list (4 B per
// corner) and W values per corner from rows that lie all over the source, so
// the reads are gathers; at the main path's sizes the whole source (at most
// a few MB) sits in the 50 MB L2 after the per-triangle pass that wrote it.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace vertex_sum {

constexpr int kThreads = 256;

// A product that is never contracted into a multiply-add with the sum after
// it, whatever -fmad says, so the weighted sum rounds as its twin does.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Member m = blockIdx.y reads its sources at m * src_rows rows (src_rows =
// 3T corner rows per member; the weight at m * src_rows / 3) and writes its
// output at m * n rows; the CSR and the mask are shared.  With one member
// (gridDim.y = 1) every offset is zero.
template <typename T, int Wa, int Wb, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    vertex_sum_kernel(const int32_t* __restrict__ offsets, const int32_t* __restrict__ slots,
                      const T* __restrict__ src_a, T* __restrict__ out_a,
                      const T* __restrict__ src_b, T* __restrict__ out_b,
                      const T* __restrict__ weight, const bool* __restrict__ mask, int n,
                      int64_t src_rows) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int64_t member = blockIdx.y;
  src_a += member * src_rows * Wa;
  out_a += member * n * Wa;
  if constexpr (Wb > 0) {
    src_b += member * src_rows * Wb;
    out_b += member * n * Wb;
  }
  if constexpr (kWeighted) weight += member * (src_rows / 3);
  const int lo = offsets[v];
  const int hi = offsets[v + 1];
  T a[Wa];
  T b[Wb > 0 ? Wb : 1];
#pragma unroll
  for (int c = 0; c < Wa; ++c) a[c] = T(0);
#pragma unroll
  for (int c = 0; c < (Wb > 0 ? Wb : 1); ++c) b[c] = T(0);
  for (int s = lo; s < hi; ++s) {
    const int64_t slot = slots[s];
    if constexpr (kWeighted) {
      const int64_t tri = slot / 3;
      const T w = mask[tri] ? weight[tri] : T(0);
#pragma unroll
      for (int c = 0; c < Wa; ++c) a[c] += mul_rn(w, src_a[slot * Wa + c]);
    } else {
#pragma unroll
      for (int c = 0; c < Wa; ++c) a[c] += src_a[slot * Wa + c];
    }
    if constexpr (Wb > 0) {
#pragma unroll
      for (int c = 0; c < Wb; ++c) b[c] += src_b[slot * Wb + c];
    }
  }
#pragma unroll
  for (int c = 0; c < Wa; ++c) out_a[(int64_t)v * Wa + c] = a[c];
  if constexpr (Wb > 0) {
#pragma unroll
    for (int c = 0; c < Wb; ++c) out_b[(int64_t)v * Wb + c] = b[c];
  }
}

inline dim3 vertex_grid(int n, int members) {
  return dim3((unsigned int)((n + kThreads - 1) / kThreads), (unsigned int)members);
}

// Launches on ``stream``; n vertices, ``members`` stacked members of
// ``src_rows`` corner rows each (src_rows is read only with members > 1).
// Returns nothing: the caller checks cudaGetLastError() once for its whole
// launch sequence.
template <typename T, int Wa, int Wb = 0>
inline void launch(const int32_t* offsets, const int32_t* slots, const T* src_a, T* out_a,
                   const T* src_b, T* out_b, int n, cudaStream_t stream, int members = 1,
                   int64_t src_rows = 0) {
  if (n > 0 && members > 0) {
    vertex_sum_kernel<T, Wa, Wb, false><<<vertex_grid(n, members), kThreads, 0, stream>>>(
        offsets, slots, src_a, out_a, src_b, out_b, nullptr, nullptr, n, src_rows);
  }
}

// out[v] = sum over v's slots of w * src[slot], w = mask[tri] ? weight[tri]
// : 0 with tri = slot / 3.
template <typename T, int W>
inline void launch_weighted(const int32_t* offsets, const int32_t* slots, const T* src,
                            const T* weight, const bool* mask, T* out, int n,
                            cudaStream_t stream, int members = 1, int64_t src_rows = 0) {
  if (n > 0 && members > 0) {
    vertex_sum_kernel<T, W, 0, true><<<vertex_grid(n, members), kThreads, 0, stream>>>(
        offsets, slots, src, out, nullptr, nullptr, weight, mask, n, src_rows);
  }
}

}  // namespace vertex_sum
