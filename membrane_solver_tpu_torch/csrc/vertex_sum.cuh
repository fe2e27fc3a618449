// Deterministic sum of per-corner rows into per-vertex rows: a thread per row, a chunk's loads in flight.
//
// Shared by frozen_tilt.cu, tri_kernels.cu and vertex_sum.cu.  It takes the
// place of the index_add scatter that followed each per-triangle kernel (the
// JAX package's segment sums in device/geo.py, scatter_add_rows): where
// index_add adds with float atomics in an order that changes from run to
// run, each vertex row here is ((0 + c_0) + c_1) + ... over its corner slots
// in a fixed order, so the sums are the same bits on every run.
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
// Layout: one thread per vertex row, kRowsPerBlock rows per block; the row's
// corners go in chunks of kChunk.  A chunk's loads are issued before any is
// used: the row's offsets pair, then every slot of the chunk (contiguous),
// then every corner's Wa (+ Wb) values and, weighted, its triangle's weight
// and mask (mul_rn(w, x) formed as the load lands).  So a chunk costs three
// dependent round trips (offsets, slots, values) where walking the slots one
// by one cost two per corner.  The adds then take the chunk's corners in
// slot order into a running sum that starts at +0 and goes on over the
// row's chunks: the same chain of adds on the same values as walking the
// slots, never a tree, so the bits are those of the twin
// (kernels/vertex_sum.reference).
//
// The sizes, kChunk = 8 and kRowsPerBlock = 32, were the fastest at kozlov
// L3 on an H100 80GB HBM3 at 700 W, against 4 and 16 corners per chunk and
// 64- and 128-row blocks, and within 3% of the fastest over 8 members
// (64-row blocks); this layout beat groups of 4, 8, 16 and 32 lanes per
// row at both (one corner per lane, the sum passed by warp shuffles: their
// shuffles cost instructions per row that a launch of many rows, the
// member axis, pays for; PERF.md §6).  A kozlov row has 3-6 corners (16
// at one vertex), so one chunk
// covers it, and 32-row blocks put 339 blocks on the 132 SMs at L3 (one
// thread per row in 256-thread blocks gave 43).  A long row of a skewed
// slot CSR (state.slot_csr: a group sum, the spare row) goes in chunks of 8.
//
// What bounds it on an H100: bytes, then latency.  At the kozlov L3 lane
// (N = 10,817, T = 21,504, width 3, float32) the function moves 1.21 MB
// (corner rows, the CSR, vertex rows), 0.36 us at 3.35 TB/s; the corner
// rows are gathers from a source (at most a few MB) that sits in the 50 MB
// L2 after the per-triangle pass that wrote it, so the time is the chain
// of round trips and the blocks in flight.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace vertex_sum {

// Corners per chunk (kernels/vertex_sum.CHUNK) and rows per block (above).
constexpr int kChunk = 8;
constexpr int kRowsPerBlock = 32;

// A product that is never contracted into a multiply-add with the sum after
// it, whatever -fmad says, so the weighted sum rounds as its twin does.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Member m = blockIdx.y reads its sources at m * src_rows rows (src_rows =
// 3T corner rows per member; the weight at m * src_rows / 3) and writes its
// output at m * n rows; the CSR and the mask are shared.  With one member
// (gridDim.y = 1) every offset is zero.  kPaired: both width-3 sources lie
// in one array of 6-float corner rows (a's three values, then b's; src_b
// unused), a corner three 8-byte loads where two 12-byte rows took six.
// Unweighted, a row whose ``mask`` entry is set (a null mask: none) is
// skipped: its sum is written elsewhere (a member gradient's interior
// vertices, summed in the triangle pass: add_interior below).
template <typename T, int Wa, int Wb, bool kWeighted, bool kPaired = false>
__global__ void __launch_bounds__(kRowsPerBlock)
    vertex_sum_kernel(const int32_t* __restrict__ offsets, const int32_t* __restrict__ slots,
                      const T* __restrict__ src_a, T* __restrict__ out_a,
                      const T* __restrict__ src_b, T* __restrict__ out_b,
                      const T* __restrict__ weight, const bool* __restrict__ mask, int n,
                      int64_t src_rows) {
  static_assert(!kPaired || (Wa == 3 && Wb == 3 && !kWeighted), "pairs are two width-3 rows");
  constexpr int kB = Wb > 0 ? Wb : 1;
  constexpr int kRowA = kPaired ? 6 : Wa;  // floats between source a's corner rows
  const int v = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (v >= n) return;
  if constexpr (!kWeighted) {
    if (mask != nullptr && mask[v]) return;
  }
  const int64_t member = blockIdx.y;
  src_a += member * src_rows * kRowA;
  out_a += member * n * Wa;
  if constexpr (Wb > 0) {
    if constexpr (!kPaired) src_b += member * src_rows * Wb;
    out_b += member * n * Wb;
  }
  if constexpr (kWeighted) weight += member * (src_rows / 3);
  const int lo = offsets[v];
  const int hi = offsets[v + 1];
  T a[Wa];
  T b[kB];
#pragma unroll
  for (int c = 0; c < Wa; ++c) a[c] = T(0);
#pragma unroll
  for (int c = 0; c < kB; ++c) b[c] = T(0);
  for (int first = lo; first < hi; first += kChunk) {
    int64_t slot[kChunk];
#pragma unroll
    for (int p = 0; p < kChunk; ++p) {
      slot[p] = first + p < hi ? (int64_t)slots[first + p] : int64_t(-1);
    }
    T xa[kChunk][Wa];
    T xb[kChunk][kB];
#pragma unroll
    for (int p = 0; p < kChunk; ++p) {
      if (slot[p] < 0) continue;
      const int64_t at = slot[p];
      if constexpr (kWeighted) {
        const int64_t tri = at / 3;
        const bool keep = mask[tri];
        const T wt = weight[tri];
        const T w = keep ? wt : T(0);
#pragma unroll
        for (int c = 0; c < Wa; ++c) xa[p][c] = mul_rn(w, src_a[at * Wa + c]);
      } else if constexpr (kPaired) {
        const float2* row = reinterpret_cast<const float2*>(src_a + at * 6);
        const float2 x = row[0], y = row[1], z = row[2];
        xa[p][0] = x.x;
        xa[p][1] = x.y;
        xa[p][2] = y.x;
        xb[p][0] = y.y;
        xb[p][1] = z.x;
        xb[p][2] = z.y;
      } else {
#pragma unroll
        for (int c = 0; c < Wa; ++c) xa[p][c] = src_a[at * Wa + c];
      }
      if constexpr (Wb > 0 && !kPaired) {
#pragma unroll
        for (int c = 0; c < Wb; ++c) xb[p][c] = src_b[at * Wb + c];
      }
    }
    // the adds, in slot order
#pragma unroll
    for (int p = 0; p < kChunk; ++p) {
      if (slot[p] < 0) continue;
#pragma unroll
      for (int c = 0; c < Wa; ++c) a[c] += xa[p][c];
      if constexpr (Wb > 0) {
#pragma unroll
        for (int c = 0; c < Wb; ++c) b[c] += xb[p][c];
      }
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
  return dim3((unsigned int)((n + kRowsPerBlock - 1) / kRowsPerBlock), (unsigned int)members);
}

// Launches on ``stream``; n vertices, ``members`` stacked members of
// ``src_rows`` corner rows each (src_rows is read only with members > 1);
// the rows where ``skip`` (n,; null: none) is set are left as they are.
// Returns nothing: the caller checks cudaGetLastError() once for its whole
// launch sequence.
template <typename T, int Wa, int Wb = 0>
inline void launch(const int32_t* offsets, const int32_t* slots, const T* src_a, T* out_a,
                   const T* src_b, T* out_b, int n, cudaStream_t stream, int members = 1,
                   int64_t src_rows = 0, const uint8_t* skip = nullptr) {
  if (n > 0 && members > 0) {
    vertex_sum_kernel<T, Wa, Wb, false><<<vertex_grid(n, members), kRowsPerBlock, 0, stream>>>(
        offsets, slots, src_a, out_a, src_b, out_b, nullptr,
        reinterpret_cast<const bool*>(skip), n, src_rows);
  }
}

// Two width-3 float sums from one array of paired corner rows (kPaired):
// ``pairs`` (members, src_rows, 6), out_a and out_b (members, n, 3); the rows
// where ``skip`` (n,; null: none) is set are left as they are.
template <typename T>
inline void launch_pairs(const int32_t* offsets, const int32_t* slots, const T* pairs,
                         const uint8_t* skip, T* out_a, T* out_b, int n, cudaStream_t stream,
                         int members = 1, int64_t src_rows = 0) {
  if (n > 0 && members > 0) {
    vertex_sum_kernel<T, 3, 3, false, true><<<vertex_grid(n, members), kRowsPerBlock, 0, stream>>>(
        offsets, slots, pairs, out_a, nullptr, out_b, nullptr,
        reinterpret_cast<const bool*>(skip), n, src_rows);
  }
}

// out[v] = sum over v's slots of w * src[slot], w = mask[tri] ? weight[tri]
// : 0 with tri = slot / 3.
template <typename T, int W>
inline void launch_weighted(const int32_t* offsets, const int32_t* slots, const T* src,
                            const T* weight, const bool* mask, T* out, int n,
                            cudaStream_t stream, int members = 1, int64_t src_rows = 0) {
  if (n > 0 && members > 0) {
    vertex_sum_kernel<T, W, 0, true><<<vertex_grid(n, members), kRowsPerBlock, 0, stream>>>(
        offsets, slots, src, out, nullptr, nullptr, weight, mask, n, src_rows);
  }
}

// ---------------------------------------------------------------------
// in-tile sums: a member gradient's interior vertices in the triangle pass
// ---------------------------------------------------------------------
// A vertex whose corners all lie in one tile of triangles (kernels/
// vertex_sum.tile_sums: the tile's interior vertices) is summed by the
// tile's block from its shared-memory corner slab, W values a corner
// (local corner k = slot - 3 * first triangle at s_corner + k * W), in the
// corner CSR's slot order from +0: the adds the vertex sum would make on
// the same values, so the same bits.  The vertex sum then skips those rows.

// Corners of an interior vertex read ahead of its sum (kozlov: 3-16 a vertex).
constexpr int kAhead = 8;

// The CSR range and first kAhead local corners of interior vertex v.
__device__ __forceinline__ void read_interior(int v, const int32_t* __restrict__ offsets,
                                              const int32_t* __restrict__ slots, int base,
                                              int& lo, int& hi, int (&ahead)[kAhead]) {
  lo = offsets[v];
  hi = offsets[v + 1];
#pragma unroll
  for (int q = 0; q < kAhead; ++q) ahead[q] = lo + q < hi ? slots[lo + q] - base : 0;
}

// An interior vertex's row, ((0 + c_0) + c_1) + ... over its corners in CSR
// slot order, from the corner slab: its first kAhead corners' local indices
// in ``ahead``, the rest read from ``slots`` (less ``base``, the tile's first
// corner).  W = 3: the row to out_a; W = 6: two width-3 rows, values 0-2 to
// out_a and 3-5 to out_b.
template <typename T, int W>
__device__ __forceinline__ void add_interior(const T* s_corner, const int (&ahead)[kAhead],
                                             const int32_t* __restrict__ slots, int lo, int hi,
                                             int base, T* __restrict__ out_a,
                                             T* __restrict__ out_b) {
  static_assert(W == 3 || W == 6, "one or two width-3 rows");
  T acc[W];
#pragma unroll
  for (int x = 0; x < W; ++x) acc[x] = T(0);
#pragma unroll
  for (int q = 0; q < kAhead; ++q) {
    if (lo + q < hi) {
      const T* cr = s_corner + ahead[q] * W;
#pragma unroll
      for (int x = 0; x < W; ++x) acc[x] += cr[x];
    }
  }
  for (int s = lo + kAhead; s < hi; ++s) {
    const T* cr = s_corner + (slots[s] - base) * W;
#pragma unroll
    for (int x = 0; x < W; ++x) acc[x] += cr[x];
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) out_a[x] = acc[x];
  if constexpr (W == 6) {
#pragma unroll
    for (int x = 0; x < 3; ++x) out_b[x] = acc[3 + x];
  }
}

}  // namespace vertex_sum
