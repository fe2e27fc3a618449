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
// (Wb = 0 for one).  The weighted form (launch_weighted, weighted_sum_kernel:
// kernel 4's tilt backward) scales each corner row by a per-triangle weight,
// zero where a per-triangle mask is false, as it adds it: one launch where a
// scale pass and a sum would take two.
//
// Layout: one thread per vertex row, kRowsPerBlock rows per block; the row's
// corners go in chunks of kChunk.  A chunk's loads are issued before any is
// used: the row's offsets pair, then every slot of the chunk (contiguous),
// then every corner's Wa (+ Wb) values and, weighted, its triangle's weight
// and mask.  So a chunk costs three dependent round trips (offsets, slots,
// values) where walking the slots one by one cost two per corner.  The adds
// then take the chunk's corners in slot order into a running sum that starts
// at +0 and goes on over the row's chunks (weighted: each product mul_rn(w,
// x) formed in that loop): the same chain of adds on the same values as
// walking the slots, never a tree, so the bits are those of the twin
// (kernels/vertex_sum.reference).  The weighted form once formed each
// product in the load loop, as its loads landed: each corner's product then
// waited on its own loads before the next corner's were issued, and the
// form took twice the plain sum's time; any per-triangle load cost ~2.3 us
// of the 5.0 at kozlov L3 (tools/p1_div_cut_split.py, PERF.md §6).  With
// every load first, the single weighted sum takes ~1.2x the plain one.  Its
// member form takes a group of members a thread (the wrapper's choice: one
// with each member's source, where larger groups' chains were slower, three
// with a shared one), reading the slots, triangle indices (an int32
// division) and mask once for the group and a shared source's row once.
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
// 3T corner rows per member) and writes its output at m * n rows; the CSR
// is shared.  With one member (gridDim.y = 1) every offset is zero.
// kPaired: both width-3 sources lie in one array of 6-float corner rows (a's
// three values, then b's; src_b unused), a corner three 8-byte loads where
// two 12-byte rows took six.  A row whose ``skip`` entry is set (a null
// skip: none) is left as it is: its sum is written elsewhere (a member
// gradient's interior vertices, summed in the triangle pass: add_interior
// below).
template <typename T, int Wa, int Wb, bool kPaired = false>
__global__ void __launch_bounds__(kRowsPerBlock)
    vertex_sum_kernel(const int32_t* __restrict__ offsets, const int32_t* __restrict__ slots,
                      const T* __restrict__ src_a, T* __restrict__ out_a,
                      const T* __restrict__ src_b, T* __restrict__ out_b,
                      const uint8_t* __restrict__ skip, int n, int64_t src_rows) {
  static_assert(!kPaired || (Wa == 3 && Wb == 3), "pairs are two width-3 rows");
  constexpr int kB = Wb > 0 ? Wb : 1;
  constexpr int kRowA = kPaired ? 6 : Wa;  // floats between source a's corner rows
  const int v = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (v >= n) return;
  if (skip != nullptr && skip[v]) return;
  const int64_t member = blockIdx.y;
  src_a += member * src_rows * kRowA;
  out_a += member * n * Wa;
  if constexpr (Wb > 0) {
    if constexpr (!kPaired) src_b += member * src_rows * Wb;
    out_b += member * n * Wb;
  }
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
      if constexpr (kPaired) {
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

// The weighted form: out_m[v] = sum over v's slots s, in slot order from +0,
// of mul_rn(w, src_m[s]) with w = mask[t] ? weight_m[t] : 0, t = s / 3.
// Block (x, y): rows x * kRowsPerBlock ... for the group of members
// y * kM .. y * kM + kM - 1 (the last group may hold fewer); one thread a
// row.  The thread reads its row's offsets, its chunk's slots, each slot's
// triangle (an int32 division) and mask once for the group, then every
// member's weights and corner rows (a shared source's row once), all of a
// chunk's loads in flight, and keeps one running sum a member: the adds a
// one-member launch makes on the same products, so the same bits.
// ``src_stride`` / ``weight_stride``: values between two members' sources /
// weights (0: shared).
template <typename T, int W, int kM>
__global__ void __launch_bounds__(kRowsPerBlock)
    weighted_sum_kernel(const int32_t* __restrict__ offsets, const int32_t* __restrict__ slots,
                        const T* __restrict__ src, int64_t src_stride,
                        const T* __restrict__ weight, int64_t weight_stride,
                        const bool* __restrict__ mask, T* __restrict__ out, int n, int members) {
  const int v = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (v >= n) return;
  const int64_t first_member = (int64_t)blockIdx.y * kM;
  const int here_m = members - first_member < kM ? (int)(members - first_member) : kM;
  const bool shared_src = src_stride == 0;
  src += first_member * src_stride;
  weight += first_member * weight_stride;
  out += first_member * n * W;
  const int lo = offsets[v];
  const int hi = offsets[v + 1];
  T acc[kM][W];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int c = 0; c < W; ++c) acc[m][c] = T(0);
  }
  for (int first = lo; first < hi; first += kChunk) {
    int slot[kChunk];
#pragma unroll
    for (int p = 0; p < kChunk; ++p) slot[p] = first + p < hi ? slots[first + p] : -1;
    // every load of the chunk first: each slot's mask, the members' weights and rows (a
    // shared source's once); no product waits inside this loop
    bool keep[kChunk];
    T wt[kM][kChunk];
    T y[kM][kChunk][W];
#pragma unroll
    for (int p = 0; p < kChunk; ++p) {
      if (slot[p] < 0) continue;
      const int tri = (int)((unsigned int)slot[p] / 3u);
      keep[p] = mask[tri];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (m >= here_m) break;
        wt[m][p] = weight[m * weight_stride + tri];
        if (m == 0 || !shared_src) {
          const T* row = src + m * src_stride + (int64_t)slot[p] * W;
#pragma unroll
          for (int c = 0; c < W; ++c) y[m][p][c] = row[c];
        }
      }
    }
    // then the products and the adds, in slot order, each member its own chain
#pragma unroll
    for (int p = 0; p < kChunk; ++p) {
      if (slot[p] < 0) continue;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (m >= here_m) break;
        const T w = keep[p] ? wt[m][p] : T(0);
#pragma unroll
        for (int c = 0; c < W; ++c) {
          acc[m][c] += mul_rn(w, shared_src ? y[0][p][c] : y[m][p][c]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    if (m >= here_m) break;
#pragma unroll
    for (int c = 0; c < W; ++c) out[m * (int64_t)n * W + (int64_t)v * W + c] = acc[m][c];
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
    vertex_sum_kernel<T, Wa, Wb><<<vertex_grid(n, members), kRowsPerBlock, 0, stream>>>(
        offsets, slots, src_a, out_a, src_b, out_b, skip, n, src_rows);
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
    vertex_sum_kernel<T, 3, 3, true><<<vertex_grid(n, members), kRowsPerBlock, 0, stream>>>(
        offsets, slots, pairs, out_a, nullptr, out_b, skip, n, src_rows);
  }
}

// The largest group of members a thread of the weighted form takes.
constexpr int kMaxWeightedGroup = 4;

template <typename T, int W, int kM>
inline void weighted_group(const int32_t* offsets, const int32_t* slots, const T* src,
                           int64_t src_stride, const T* weight, int64_t weight_stride,
                           const bool* mask, T* out, int n, cudaStream_t stream, int members) {
  weighted_sum_kernel<T, W, kM><<<vertex_grid(n, (members + kM - 1) / kM), kRowsPerBlock, 0,
                                  stream>>>(offsets, slots, src, src_stride, weight,
                                            weight_stride, mask, out, n, members);
}

// out[m][v] = sum over v's slots of w * src[m][slot], w = mask[tri] ?
// weight[m][tri] : 0 with tri = slot / 3, in groups of ``group`` members a
// thread; ``src_stride`` and ``weight_stride`` as weighted_sum_kernel's (with
// one member: unread).  False (nothing launched) for another group.
template <typename T, int W>
inline bool launch_weighted(const int32_t* offsets, const int32_t* slots, const T* src,
                            int64_t src_stride, const T* weight, int64_t weight_stride,
                            const bool* mask, T* out, int n, cudaStream_t stream,
                            int members = 1, int group = 1) {
  if (n < 1 || members < 1) return group >= 1 && group <= kMaxWeightedGroup;
  switch (group) {
    case 1: weighted_group<T, W, 1>(offsets, slots, src, src_stride, weight, weight_stride, mask,
                                    out, n, stream, members); break;
    case 2: weighted_group<T, W, 2>(offsets, slots, src, src_stride, weight, weight_stride, mask,
                                    out, n, stream, members); break;
    case 3: weighted_group<T, W, 3>(offsets, slots, src, src_stride, weight, weight_stride, mask,
                                    out, n, stream, members); break;
    case 4: weighted_group<T, W, 4>(offsets, slots, src, src_stride, weight, weight_stride, mask,
                                    out, n, stream, members); break;
    default: return false;
  }
  return true;
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
