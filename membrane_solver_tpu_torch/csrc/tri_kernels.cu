// Per-triangle geometry kernels, float and double.
//
// Replace the Pallas kernels of membrane_solver_tpu/pallas_kernels/tri_kernels.py,
// each together with the work that surrounded its call:
//
//   tri_surface_energy    <- _surface_kernel :80 (surface_corner_grads_pallas
//                            :110), with the tension mask before it, the sum
//                            of the energies and the scatter of the corner
//                            gradients after it
//   tri_curvature_data    <- _curvature_kernel :143 (curvature_corners_pallas
//                            :193) and the stock geo.curvature_data scatter
//   tri_curvature_data_bwd   (its backward; the Pallas kernel had none: JAX
//                            differentiates the stock geo.curvature_data)
//   tri_p1_div            <- _p1_div_kernel :228 (p1_divergence_pallas :262)
//                            with the stock p1_triangle_divergence masks
//   tri_p1_div_bwd           (its backward in the tilts: JAX differentiates
//                            the stock function)
//
// tri_surface_fwd and tri_curvature_fwd / tri_curvature_bwd give the
// per-triangle outputs with no sums (the tests and the card checks): the
// surface and curvature backward kernels of the whole calls, and a thread
// per triangle for the curvature forward.  Every kernel gathers its corners
// from the (Nv, 3) positions (and tilts) through the (T, 3) int64 tri_rows
// itself and writes per-triangle rows in the layout of the JAX functions
// (corner vectors as (T, 3, 3), index corner * 3 + xyz).  A row index
// outside [0, Nv) makes that triangle's outputs NaN instead of reading out
// of bounds.
//
// The whole calls, with no atomics on a float: every vertex sum adds in the
// order of the topology's corner CSR, and the surface energy goes through a
// last-block sum of double partials (block_sum.cuh), so every call gives the
// same bits on every run.
// - tri_surface_energy: the surface kernel reads tri_valid and the tension
//   itself, sums the energy into one scalar and, with the gradient, writes
//   the corner gradients +dE/dv to a (T, 3, 3) scratch that stays in L2; the
//   vertex-sum kernel (vertex_sum.cuh) adds them into (Nv, 3).  It is the
//   one-member case of the member kernel (below), every corner through the
//   scratch.
// - tri_curvature_data: one launch, a lane group per vertex row of the
//   corner CSR (below): each lane recomputes one slot's triangle and writes
//   that corner's cotangent and Meyer area (outputs); the group adds the
//   corner mean-curvature vectors and areas into k_vecs (Nv, 3) and
//   vertex_areas (Nv,) in slot order.  No scratch.  Its backward: the tiled
//   backward kernel reads the vertex upstreams through tri_rows itself and
//   writes corner gradients to a (T, 3, 3) scratch that the vertex-sum
//   kernel adds into (Nv, 3).  Any upstream may be null.
// - tri_p1_div: div zeroed on invalid triangles, the area zeroed where the
//   triangle is invalid or below the area floor, and the P1 shape gradients
//   g (T, 3, 3), written only where the caller asks for them (grads not
//   null: the tilts take a gradient, or the caller reads g); the one-member
//   case of the member kernel (below).  tri_p1_div_bwd: dE/dt_v = sum over
//   the CSR slots (t, c) of v of [valid_t] dE/ddiv_t g[t, c], the weighted
//   vertex sum (vertex_sum.cuh), one launch.
//
// The arithmetic follows the plain twins in device/geo.py and
// device/tilt_ops.py operation by operation; the file is built with
// -fmad=false so that no multiply-add is contracted, which keeps the Meyer
// obtuse-branch tests (c < 0) on the same side as the twin's where the
// cotangent sits at a tie (the right triangles of a refined cube).  Every
// curvature value comes from one expression tree (curv_of, curv_corner,
// curv_adjoint) whichever kernel computes it, so the whole calls give the
// bits of the per-triangle kernels summed by the vertex sum.
//
// What bounds them on an H100: bytes, then latency.  Counted at the kozlov
// L3 lane (Nv = 10,817, T = 21,504, float32), each call's own inputs read
// once and outputs written once (the corner CSR, which another scatter
// design would not need, not counted):
// - surface energy 0.75 MB (positions 0.13, int64 tri_rows 0.52, the mask,
//   the tension), 0.225 us at 3.35 TB/s; with the vertex gradient 0.88 MB,
//   0.264 us;
// - P1 divergence 1.74 MB (positions, tilts, tri_rows, the mask in; div,
//   area, g out), 0.520 us; without g 0.97 MB, 0.289 us; its tilt backward
//   1.01 MB (g, the mask, the upstream in, (Nv, 3) out), 0.302 us;
// - curvature data 1.36 MB, 0.405 us; its backward 0.97 MB, 0.290 us.
// Some 60-140 flops per triangle (320 in the curvature backward), far below
// either peak.  So the surface, divergence and curvature-backward kernels
// are laid out for the memory system: 128 triangles per block (168 blocks
// at L3, work on every one of the 132 SMs); the block's 3,072-byte
// tri_rows slab is loaded into shared memory as 16-byte vectors, then the
// corners are gathered through L2 with __ldg (positions and tilts are 0.13
// MB each); the (T, 3, 3) outputs are staged in shared memory and written
// as contiguous 16-byte stores instead of nine 36-byte-strided scalar
// stores per thread.  The curvature backward
// recomputes the forward in registers rather than reading saved
// intermediates, which trades ~100 flops for ~200 bytes per triangle.
//
// The curvature forward's whole call makes one launch and keeps no
// (T, 3, 3) scratch: a lane group of kRowLanes = 8 lanes per corner-CSR
// row (a kozlov row has 3-6 slots, 16 at one vertex) takes one slot per
// lane, so each triangle is recomputed at its three corners (~3x the flops,
// still far below the peak) and every lane's loads (the slot, the triangle's
// rows and mask, its nine position values) are in flight together; the
// ordered sum goes through shared memory, lane i < 4 of the group adding
// value i of each slot.  On an H100 this beat one thread per row with a
// chunk's loads in flight (its serial recompute needs ~200 registers),
// groups of 4 lanes, a shuffle-ordered sum, and the tiled two-launch form
// (by a quarter at one member; within a few per cent of it at eight,
// PERF.md §6).  The backward's recompute is ~3x heavier, so that layout
// lost there over the member axis and the backward keeps the tiled
// two-launch form.
//
// The member axis (the parameter sweep, parallel/sweep.py, and the batched
// line searches' candidates): the *_members entries run the same kernels
// over B stacked members, and tri_rows, the masks and the CSR are shared.
// A member's arithmetic and reduction order are those of a call on that
// member alone, so member m of a B-member call is the single call's bits.
// - tri_surface_energy_members: block (x, y) takes tile x for a group of
//   members (the wrapper's group_size: one up to 9 members, 2 above); it
//   reads the tile's rows, the mask and a shared tension once for the
//   group, issues the group's corner loads together and carries each
//   member's energy through its own block tree into the group's last-block
//   sum (block_sum::grid_sums, each total the bits of a one-member
//   launch).  With the gradient, each tile's interior vertices (8,344 of
//   kozlov L3's 10,817) are summed from the block's corner slab in the
//   corner CSR's order and written, and only the boundary corners go to the
//   scratch for the vertex sum, which skips interior rows (the tables are
//   kernel 1's, kernels/vertex_sum.tile_sums, kept once per corner CSR);
//   where under half the corners are interior vertices' (a triangle order
//   whose tiles hold few whole fans), every corner goes through the
//   scratch, as in the single call.
//   Measured at kozlov L3 on an H100 (PERF.md; tools/time_surface_members.py,
//   tools/surface_cut_split.py): larger groups lengthen each block's chain
//   of dependent steps more than they save, except where the blocks exceed
//   a wave (72 rows); the in-tile sums take 1.5-4.0 us off the vertex sum
//   and add 0.9-2.6 us to the triangle pass (its blocks are short, so the
//   sums sit on their critical path), a gain at float64 and none at
//   float32.  What bounds the energy is its sum's tail (block tree, fence,
//   counter, last block): without it the B = 8 launch takes half the time.
// - tri_p1_div_members: block (x, y) takes tile x for a group of members
//   (the wrapper's div_group_size: one with per-member positions, 4 (float)
//   or 3 (double) with shared ones); it reads the tile's rows and the mask
//   once for the group, a positions or tilts array the members share once
//   (a member stride of 0; the wrapper no longer copies it B times), and
//   with shared positions computes g and the area once and writes them once
//   (one member's, which every member's would equal).  g is written only
//   where the wrapper asks (the tilts take a gradient, or the caller reads
//   g); the bending-tilt energy and the face values drop it, and it is 64%
//   of a member's bytes at float32.  Measured at kozlov L3 on an H100
//   (PERF.md; tools/time_p1_div_members.py, tools/p1_div_cut_split.py):
//   with per-member positions larger groups lengthen each block more than
//   the shared rows save; what bounds a launch is the corner gathers
//   through L2 (a launch without g at 72 rows moves 9.4 MB and takes
//   ~35 us), and gathering a corner as one aligned pair and one scalar in
//   place of three scalars made it slower (+18%).
// - the curvature launches put the members on the grid's y axis
//   (gridDim.y = B); each kernel offsets its per-member pointers by
//   blockIdx.y.  The bytes are B times the per-member ones, less B - 1
//   reads of the shared rows (which stay in L2).

#include <cuda_runtime.h>

#include <cstdint>

#include "block_sum.cuh"
#include "vertex_sum.cuh"

namespace {

constexpr int kThreads = 256;  // the per-triangle curvature forward: threads per block
constexpr int kTile = 128;     // the tiled kernels: triangles per block
constexpr double kEpsArea = 1e-12;  // geo.EPS_AREA

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> neg(V3<T> a) {
  return {-a.x, -a.y, -a.z};
}
template <typename T>
__device__ __forceinline__ V3<T> scale(T s, V3<T> a) {
  return {s * a.x, s * a.y, s * a.z};
}
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

template <typename T>
__device__ __forceinline__ void store(T* out, int i, V3<T> v) {
  out[3 * i] = v.x;
  out[3 * i + 1] = v.y;
  out[3 * i + 2] = v.z;
}

// Loads the three corners of triangle t; false if a row is out of range.
template <typename T>
__device__ __forceinline__ bool load_corners(const T* __restrict__ xs,
                                             const int64_t* __restrict__ rows, int t,
                                             int64_t nv, V3<T>* c) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int64_t r = rows[3 * t + k];
    if (r < 0 || r >= nv) {
      ok = false;
      c[k] = {T(0), T(0), T(0)};
    } else {
      c[k] = {xs[3 * r], xs[3 * r + 1], xs[3 * r + 2]};
    }
  }
  return ok;
}

template <typename T>
__device__ __forceinline__ T nan_of() {
  return T(__longlong_as_double(0x7ff8000000000000LL));
}

// Value c (0, 1 or 2) of three, by selects (no indexed local array).
template <typename T>
__device__ __forceinline__ T pick(int c, T a, T b, T d) {
  return c == 0 ? a : (c == 1 ? b : d);
}

// ---------------------------------------------------------------------
// tiles of kTile triangles: tri_rows in, (T, 3, 3) rows out
// ---------------------------------------------------------------------

// The block's tri_rows slab (3 * here int64, 16-byte aligned at its start)
// into shared memory as 16-byte loads, the odd last value plainly.
__device__ __forceinline__ void load_rows(const int64_t* __restrict__ rows, int first, int here,
                                          int64_t* s_rows) {
  const int64_t* src = rows + 3 * (int64_t)first;
  const int n = 3 * here;
  const longlong2* src2 = reinterpret_cast<const longlong2*>(src);
  longlong2* dst2 = reinterpret_cast<longlong2*>(s_rows);
  for (int i = threadIdx.x; i < n / 2; i += kTile) dst2[i] = __ldg(src2 + i);
  if ((n & 1) && threadIdx.x == 0) s_rows[n - 1] = __ldg(src + n - 1);
  __syncthreads();
}

// The three corners under row indices r[0..2], through the read-only path;
// false if a row is out of range (its corner is then zero).
template <typename T>
__device__ __forceinline__ bool gather(const T* __restrict__ xs, const int64_t* r, int64_t nv,
                                       V3<T>* c) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int64_t i = r[k];
    if (i < 0 || i >= nv) {
      ok = false;
      c[k] = {T(0), T(0), T(0)};
    } else {
      c[k] = {__ldg(xs + 3 * i), __ldg(xs + 3 * i + 1), __ldg(xs + 3 * i + 2)};
    }
  }
  return ok;
}

// Thread tid's three corner vectors into the block's (kTile, 3, 3) tile.
template <typename T>
__device__ __forceinline__ void put_corners(T* s_tile, int tid, const V3<T>* d) {
#pragma unroll
  for (int k = 0; k < 3; ++k) store(s_tile, 3 * tid + k, d[k]);
}

// ``n`` values from shared ``src`` (16-byte aligned) to global ``dst`` by
// the whole block as coalesced 16-byte stores, the last values past a
// 16-byte multiple plainly; all plainly where ``dst`` is not 16-byte
// aligned (a member's slab when T * 9 values are not a 16-byte multiple).
template <typename T>
__device__ __forceinline__ void store_slab(T* __restrict__ dst, const T* src, int n) {
  constexpr int kVec = 16 / sizeof(T);
  const int n16 = reinterpret_cast<uintptr_t>(dst) % 16 ? 0 : n / kVec;
  for (int i = threadIdx.x; i < n16; i += kTile) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  for (int i = n16 * kVec + threadIdx.x; i < n; i += kTile) dst[i] = src[i];
}

// ---------------------------------------------------------------------
// surface: e = gamma * A, corner gradients dE/dv_k = gamma/2 * n_hat x (v_{k+2} - v_{k+1})
// ---------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T surface_terms(const V3<T>* v, T g, V3<T>* d) {
  const T eps = T(kEpsArea);
  const V3<T> nrm = cross(sub(v[1], v[0]), sub(v[2], v[0]));
  const T dbl = sqrt(dot(nrm, nrm));
  const bool ok = dbl >= eps;
  const T den = dbl > eps ? dbl : eps;
  const V3<T> n_hat = ok ? V3<T>{nrm.x / den, nrm.y / den, nrm.z / den} : V3<T>{T(0), T(0), T(0)};
  const T area = ok ? T(0.5) * dbl : T(0);
  const T half_g = T(0.5) * g;
  d[0] = scale(half_g, cross(n_hat, sub(v[2], v[1])));
  d[1] = scale(half_g, cross(n_hat, sub(v[0], v[2])));
  d[2] = scale(half_g, cross(n_hat, sub(v[1], v[0])));
  return g * area;
}

// One launch of the surface kernel: its inputs and outputs.  ``valid``
// null: every triangle counts.  ``e_tri`` non-null (one member): the
// per-triangle energies.  ``dc`` (members, T, 3, 3): the corner gradients of
// the corners the vertex sum reads (every corner where ``corner_mask`` is
// null).  ``partials`` non-null: each member's energy summed into its
// ``energy`` (block_sum.cuh).  With the tile tables (``corner_mask`` non-null,
// vertex_sum.cuh's in-tile sums) the block sums each interior vertex's
// gradient into ``dpos`` (members, nv, 3) and ``interior`` tells the vertex
// sum which rows to skip.
template <typename T>
struct Surface {
  const T* pos;
  const int64_t* rows;
  const bool* valid;
  const T* gamma;
  int64_t gamma_stride;  // 0: one tension shared by the members
  T* e_tri;
  T* dc;
  const int32_t* offsets;
  const int32_t* slots;
  const int32_t* tile_vertices;
  const int32_t* tile_offsets;
  const uint8_t* corner_mask;
  const uint8_t* interior;
  T* dpos;
  double* partials;
  unsigned int* counter;
  T* energy;
  int n;
  int64_t nv;
  int members;
};

// Block (x, y): the tile x of kTile triangles for the group of members
// y * kM .. y * kM + kM - 1 (the last group may hold fewer).  The block reads
// the tile's rows, the mask and a shared tension once for the group and
// issues the group's 9 kM corner loads together; each member's energy takes
// the block tree of a one-member launch into its own partial, and the
// group's last block adds each member's partials in block order
// (block_sum::grid_sums), so member m is the bits of a call on it alone.
// kGrad: each member's corner gradients go through the block's corner slab:
// to ``dc`` as a coalesced slab (no tables) or only the corners the mask
// names, and the tile's interior vertices summed from the slab into dpos.
template <typename T, bool kGrad, int kM>
__global__ void __launch_bounds__(kTile) surface_kernel(const Surface<T> a) {
  __shared__ alignas(16) int64_t s_rows[3 * kTile];
  __shared__ alignas(16) T s_dc[kGrad ? 9 * kTile : 2];
  // the group's first member: its positions, tension, outputs and partials;
  // the group's counter; the rows, the mask, the CSR and the tables shared
  const int64_t first_member = (int64_t)blockIdx.y * kM;
  const int here_m = a.members - first_member < kM ? (int)(a.members - first_member) : kM;
  const int64_t nv = a.nv;
  const int n = a.n;
  const T* __restrict__ pos = a.pos + first_member * nv * 3;
  const T* __restrict__ gamma = a.gamma + first_member * a.gamma_stride;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kTile;
  const int here = min(kTile, n - first);

  // with the tables, this thread's first interior vertex of the tile and its
  // corners, read while the rows land (the same for every member)
  int interior_lo = 0, interior_hi = 0, iv = -1, i_lo = 0, i_hi = 0;
  int i_ahead[vertex_sum::kAhead];
  unsigned int mask = 0;  // with the tables: bit k set where corner k goes to the scratch
  if constexpr (kGrad) {
    if (a.corner_mask != nullptr) {
      interior_lo = a.tile_offsets[blockIdx.x];
      interior_hi = a.tile_offsets[blockIdx.x + 1];
      mask = tid < here ? a.corner_mask[first + tid] : 0u;
      if (interior_lo + tid < interior_hi) {
        iv = a.tile_vertices[interior_lo + tid];
        vertex_sum::read_interior(iv, a.offsets, a.slots, 3 * first, i_lo, i_hi, i_ahead);
      }
    }
  }
  load_rows(a.rows, first, here, s_rows);

  // the rows once, then every member's corners: 9 kM loads in flight (a bad
  // row gives NaN)
  const bool live = tid < here;
  const int t = first + tid;
  bool ok = live;
  int64_t r[3] = {0, 0, 0};
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r[k] = s_rows[3 * tid + k];
      if (r[k] < 0 || r[k] >= nv) {
        ok = false;
        r[k] = 0;
      }
    }
  }
  V3<T> v[kM][3];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T* x = pos + m * nv * 3 + 3 * r[k];
      v[m][k] = ok && m < here_m ? V3<T>{__ldg(x), __ldg(x + 1), __ldg(x + 2)}
                                 : V3<T>{T(0), T(0), T(0)};
    }
  }
  const bool counted = live && (a.valid == nullptr || a.valid[t]);
  const T g_shared = counted ? gamma[t] : T(0);

  // each member's energy and corner gradients
  double e_thread[kM];
  V3<T> d[kM][3];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    e_thread[m] = 0.0;
    if (!live || m >= here_m) continue;
    const T g = (a.gamma_stride == 0 || m == 0) ? g_shared
                                                 : (counted ? gamma[m * a.gamma_stride + t] : T(0));
    T e = surface_terms(v[m], g, d[m]);
    if (!ok) {
      const T q = nan_of<T>();
      const V3<T> qv = {q, q, q};
      e = q;
      d[m][0] = d[m][1] = d[m][2] = qv;
    }
    if (a.e_tri != nullptr) a.e_tri[t] = e;
    e_thread[m] = (double)e;
  }
  if constexpr (kGrad) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      if (m >= here_m) break;  // the same for the whole block
      T* dc = a.dc + (first_member + m) * 9 * (int64_t)n;
      if (m > 0) __syncthreads();  // the last member's sums have read the corner slab
      if (live) {
        put_corners(s_dc, tid, d[m]);
        if (a.corner_mask != nullptr) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            if (mask & (1u << k)) store(dc, 3 * t + k, d[m][k]);
          }
        }
      }
      __syncthreads();
      if (a.corner_mask == nullptr) {
        store_slab(dc + 9 * (int64_t)first, s_dc, 9 * here);
      } else {
        // interior vertices: ((0 + c_0) + c_1) + ... over the vertex's
        // corners in CSR slot order, as the vertex sum adds
        T* dpos = a.dpos + (first_member + m) * nv * 3;
        if (iv >= 0) {
          vertex_sum::add_interior<T, 3>(s_dc, i_ahead, a.slots, i_lo, i_hi, 3 * first,
                                         dpos + 3 * (int64_t)iv, nullptr);
        }
        for (int j = interior_lo + tid + kTile; j < interior_hi; j += kTile) {
          const int w = a.tile_vertices[j];
          int lo, hi, ahead[vertex_sum::kAhead];
          vertex_sum::read_interior(w, a.offsets, a.slots, 3 * first, lo, hi, ahead);
          vertex_sum::add_interior<T, 3>(s_dc, ahead, a.slots, lo, hi, 3 * first,
                                         dpos + 3 * (int64_t)w, nullptr);
        }
      }
    }
  }
  // each member's energy: block partials, added in block order by the
  // group's last block (last: the gradient's stores and sums before it
  // measured faster than after it)
  if (a.partials != nullptr) {
    double total[kM];
    if (block_sum::grid_sums<kTile, kM>(e_thread, here_m, a.partials + first_member * gridDim.x,
                                        a.counter + blockIdx.y, total)) {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (m < here_m) a.energy[first_member + m] = (T)total[m];
      }
    }
  }
}

// ---------------------------------------------------------------------
// cotan curvature corners (Meyer mixed-Voronoi areas with obtuse branches)
// ---------------------------------------------------------------------
template <typename T>
struct Curv {
  V3<T> e0, e1, e2, nrm;
  T l0, l1, l2;      // squared edge lengths
  T raw;             // safe_norm(n): |n| above the floor, else 0
  T dbl;             // max(raw, EPS)
  bool dbl_live;     // d dbl / d n is nonzero (torch's clamp passes at equality)
  T c0, c1, c2;      // cotangents
  bool obt0, obt1, obt2;
};

template <typename T>
__device__ __forceinline__ Curv<T> curv_of(const V3<T>* v) {
  Curv<T> s;
  const T eps = T(kEpsArea);
  s.e0 = sub(v[2], v[1]);
  s.e1 = sub(v[0], v[2]);
  s.e2 = sub(v[1], v[0]);
  s.l0 = dot(s.e0, s.e0);
  s.l1 = dot(s.e1, s.e1);
  s.l2 = dot(s.e2, s.e2);
  s.nrm = cross(s.e1, s.e2);
  const T sq = dot(s.nrm, s.nrm);
  const bool good = sq > eps * eps;
  s.raw = good ? sqrt(sq) : T(0);
  s.dbl_live = good && s.raw >= eps;
  s.dbl = s.raw >= eps ? s.raw : eps;
  s.c0 = dot(neg(s.e1), s.e2) / s.dbl;
  s.c1 = dot(neg(s.e2), s.e0) / s.dbl;
  s.c2 = dot(neg(s.e0), s.e1) / s.dbl;
  s.obt0 = s.c0 < T(0);
  s.obt1 = s.c1 < T(0);
  s.obt2 = s.c2 < T(0);
  return s;
}

// Corner c's masked outputs, m = [valid]: the corner mean-curvature vector
// kc = m/2 (c_j (-e_j) + c_k e_k), the Meyer corner area ac (the obtuse
// branches) and the cotangent wc, with corner c's two others j = c + 1 and
// k = c + 2 (mod 3) picked by selects.  The per-triangle forward and the
// whole call's lanes both take every corner value from here.
template <typename T>
__device__ __forceinline__ void curv_corner(const V3<T>* v, bool live, int c, V3<T>* kc, T* ac,
                                            T* wc) {
  const Curv<T> s = curv_of(v);
  const T m = live ? T(1) : T(0);
  const T half = T(0.5);
  const T cj = pick(c, s.c1, s.c2, s.c0), ck = pick(c, s.c2, s.c0, s.c1);
  const V3<T> ej = pick(c, s.e1, s.e2, s.e0), ek = pick(c, s.e2, s.e0, s.e1);
  *kc = scale(m, scale(half, add(scale(cj, neg(ej)), scale(ck, ek))));

  const T area = half * s.dbl;
  const bool any_obt = s.obt0 || s.obt1 || s.obt2;
  const T lj = pick(c, s.l1, s.l2, s.l0), lk = pick(c, s.l2, s.l0, s.l1);
  T a = !any_obt ? (lj * cj + lk * ck) / T(8) : T(0);
  if (pick(c, s.obt0, s.obt1, s.obt2)) a = area / T(2);
  if (pick(c, s.obt1 || s.obt2, s.obt0 || s.obt2, s.obt0 || s.obt1)) a = area / T(4);
  *ac = a * m;
  *wc = pick(c, s.c0, s.c1, s.c2) * m;
}

template <typename T>
__global__ void curvature_fwd_kernel(const T* __restrict__ pos, const int64_t* __restrict__ rows,
                                     const bool* __restrict__ valid, T* __restrict__ cot,
                                     T* __restrict__ kv, T* __restrict__ va,
                                     T* __restrict__ tri_area, int n, int64_t nv) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  V3<T> v[3];
  if (!load_corners(pos, rows, t, nv, v)) {
    const T q = nan_of<T>();
    for (int i = 0; i < 3; ++i) cot[3 * t + i] = va[3 * t + i] = q;
    for (int i = 0; i < 9; ++i) kv[9 * t + i] = q;
    tri_area[t] = q;
    return;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    V3<T> k;
    curv_corner(v, valid[t], c, &k, va + 3 * t + c, cot + 3 * t + c);
    store(kv, 3 * t + c, k);
  }
  tri_area[t] = T(0.5) * curv_of(v).dbl;
}

// Adjoint of the Meyer corner area of corner i, whose two "other" corners
// are j and k (va_i = (l_j c_j + l_k c_k) / 8 when no angle is obtuse).
// Follows the branch the forward took, as reverse-mode AD of its where chain.
template <typename T>
__device__ __forceinline__ void va_adjoint(T g, bool obt_i, bool obt_other, bool any_obt, T lj,
                                           T cj, T lk, T ck, T& g_area, T& g_lj, T& g_cj,
                                           T& g_lk, T& g_ck) {
  if (obt_other) {
    g_area += g / T(4);
  } else if (obt_i) {
    g_area += g / T(2);
  } else if (!any_obt) {
    const T h = g / T(8);
    g_lj += h * cj;
    g_cj += h * lj;
    g_lk += h * ck;
    g_ck += h * lk;
  }
}

// Upstream of corner value i of triangle t: the per-triangle array's entry
// (if given) plus the vertex array's row under that corner (if given).
template <typename T>
__device__ __forceinline__ T upstream(const T* __restrict__ per_tri, int64_t i,
                                      const T* __restrict__ per_vertex, int64_t j) {
  T g = per_tri ? per_tri[i] : T(0);
  if (per_vertex) g += per_vertex[j];
  return g;
}

// The corner gradients dp (3 corners) of one triangle from its upstreams:
// gk_i of corner vector i, gc_i of cotangent i and gva_i of corner area i
// (these two already times m = [valid]), gA of the triangle area.
template <typename T>
__device__ __forceinline__ void curv_adjoint(const V3<T>* v, T m, V3<T> gk0, V3<T> gk1,
                                             V3<T> gk2, T gc0, T gc1, T gc2, T gA, T gva0,
                                             T gva1, T gva2, V3<T>* dp) {
  const Curv<T> s = curv_of(v);
  const T half = T(0.5);
  T gl0 = T(0), gl1 = T(0), gl2 = T(0);
  V3<T> ge0 = {T(0), T(0), T(0)}, ge1 = ge0, ge2 = ge0;

  // k0 = m/2 (c1 (-e1) + c2 e2), k1 = m/2 (c2 (-e2) + c0 e0), k2 = m/2 (c0 (-e0) + c1 e1)
  const T hm = half * m;
  gc1 += hm * dot(gk0, neg(s.e1));
  gc2 += hm * dot(gk0, s.e2);
  ge1 = add(ge1, scale(-hm * s.c1, gk0));
  ge2 = add(ge2, scale(hm * s.c2, gk0));
  gc2 += hm * dot(gk1, neg(s.e2));
  gc0 += hm * dot(gk1, s.e0);
  ge2 = add(ge2, scale(-hm * s.c2, gk1));
  ge0 = add(ge0, scale(hm * s.c0, gk1));
  gc0 += hm * dot(gk2, neg(s.e0));
  gc1 += hm * dot(gk2, s.e1);
  ge0 = add(ge0, scale(-hm * s.c0, gk2));
  ge1 = add(ge1, scale(hm * s.c1, gk2));

  // Meyer corner areas (masked)
  const bool any_obt = s.obt0 || s.obt1 || s.obt2;
  va_adjoint(gva0, s.obt0, s.obt1 || s.obt2, any_obt, s.l1, s.c1, s.l2, s.c2, gA, gl1, gc1, gl2,
             gc2);
  va_adjoint(gva1, s.obt1, s.obt0 || s.obt2, any_obt, s.l2, s.c2, s.l0, s.c0, gA, gl2, gc2, gl0,
             gc0);
  va_adjoint(gva2, s.obt2, s.obt0 || s.obt1, any_obt, s.l0, s.c0, s.l1, s.c1, gA, gl0, gc0, gl1,
             gc1);

  // area = dbl / 2; c_i = d_i / dbl with d0 = -e1.e2, d1 = -e2.e0, d2 = -e0.e1
  T gdbl = half * gA;
  gdbl -= (gc0 * s.c0 + gc1 * s.c1 + gc2 * s.c2) / s.dbl;
  const T gd0 = gc0 / s.dbl;
  const T gd1 = gc1 / s.dbl;
  const T gd2 = gc2 / s.dbl;
  ge1 = add(ge1, scale(-gd0, s.e2));
  ge2 = add(ge2, scale(-gd0, s.e1));
  ge2 = add(ge2, scale(-gd1, s.e0));
  ge0 = add(ge0, scale(-gd1, s.e2));
  ge0 = add(ge0, scale(-gd2, s.e1));
  ge1 = add(ge1, scale(-gd2, s.e0));
  ge0 = add(ge0, scale(T(2) * gl0, s.e0));
  ge1 = add(ge1, scale(T(2) * gl1, s.e1));
  ge2 = add(ge2, scale(T(2) * gl2, s.e2));

  // dbl = max(safe_norm(n), EPS), n = e1 x e2: zero below the floor
  if (s.dbl_live) {
    const V3<T> gn = scale(gdbl / s.raw, s.nrm);
    ge1 = add(ge1, cross(s.e2, gn));
    ge2 = add(ge2, cross(gn, s.e1));
  }

  // e0 = v2 - v1, e1 = v0 - v2, e2 = v1 - v0
  dp[0] = sub(ge1, ge2);
  dp[1] = sub(ge2, ge0);
  dp[2] = sub(ge0, ge1);
}

// The corner gradients dc (T, 3, 3) from the per-triangle upstreams g_cot,
// g_kv (T, 3, 3), g_va and g_area and the vertex upstreams g_kvecs (Nv, 3)
// and g_varea (Nv,) of the whole call's sums, read under the triangle's
// rows; each may be null.  Tiles of kTile triangles: the rows slab in
// shared memory, the corners gathered through L2, dc staged and stored as
// 16-byte vectors.  Member blockIdx.y offsets its positions, upstreams and
// dc; rows and valid are shared.
template <typename T>
__global__ void __launch_bounds__(kTile)
    curvature_bwd_kernel(const T* __restrict__ pos, const int64_t* __restrict__ rows,
                         const bool* __restrict__ valid, const T* __restrict__ g_cot,
                         const T* __restrict__ g_kv, const T* __restrict__ g_va,
                         const T* __restrict__ g_area, const T* __restrict__ g_kvecs,
                         const T* __restrict__ g_varea, T* __restrict__ dc, int n, int64_t nv) {
  __shared__ alignas(16) int64_t s_rows[3 * kTile];
  __shared__ alignas(16) T s_dc[9 * kTile];
  const int64_t member = blockIdx.y;
  pos += member * nv * 3;
  if (g_cot) g_cot += member * 3 * (int64_t)n;
  if (g_kv) g_kv += member * 9 * (int64_t)n;
  if (g_va) g_va += member * 3 * (int64_t)n;
  if (g_area) g_area += member * n;
  if (g_kvecs) g_kvecs += member * nv * 3;
  if (g_varea) g_varea += member * nv;
  dc += member * 9 * (int64_t)n;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kTile;
  const int here = min(kTile, n - first);
  load_rows(rows, first, here, s_rows);

  if (tid < here) {
    const int t = first + tid;
    const int64_t* r = s_rows + 3 * tid;
    V3<T> v[3], d[3];
    const bool ok = gather(pos, r, nv, v);
    const T m = valid[t] ? T(1) : T(0);
    const int64_t k0 = 9 * (int64_t)t;
    V3<T> gk[3];
    T gc[3], gva[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gk[i] = {upstream(g_kv, k0 + 3 * i, g_kvecs, 3 * r[i]),
               upstream(g_kv, k0 + 3 * i + 1, g_kvecs, 3 * r[i] + 1),
               upstream(g_kv, k0 + 3 * i + 2, g_kvecs, 3 * r[i] + 2)};
      gc[i] = (g_cot ? g_cot[3 * t + i] : T(0)) * m;
      gva[i] = upstream(g_va, 3 * (int64_t)t + i, g_varea, r[i]) * m;
    }
    curv_adjoint(v, m, gk[0], gk[1], gk[2], gc[0], gc[1], gc[2], g_area ? g_area[t] : T(0),
                 gva[0], gva[1], gva[2], d);
    if (!ok) {
      const T q = nan_of<T>();
      d[0] = d[1] = d[2] = V3<T>{q, q, q};
    }
    put_corners(s_dc, tid, d);
  }
  __syncthreads();
  store_slab(dc + 9 * (int64_t)first, s_dc, 9 * here);
}

// ---------------------------------------------------------------------
// the curvature whole call: a lane group per vertex row of the corner CSR
// ---------------------------------------------------------------------
// Row v's slots (t, c) go one per lane, kRowLanes at a time: each lane
// recomputes its triangle t and takes corner c (curv_corner).  The lanes
// put their four values (k_c and va_c) in shared memory, and lane i < 4 of
// the group adds value i of the chunk's slots in slot order, going on over
// the row's chunks: ((0 + s_0) + s_1) + ..., the chain the vertex sum makes
// over the per-triangle kernel's outputs.
constexpr int kRowLanes = 8;      // lanes per vertex row
constexpr int kRowThreads = 128;  // threads per block: 16 rows
constexpr int kSumStride = 5;     // shared values per lane, 4 padded (no bank conflicts)

// Row v: cot[t, c] and va[t, c] for each of its slots (t, c), k_vecs[v] and
// vertex_areas[v] the sums of corner c's vector and area over the slots.
// Member blockIdx.y offsets its positions and outputs; rows, valid and the
// CSR are shared.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    curvature_data_kernel(const T* __restrict__ pos, const int64_t* __restrict__ rows,
                          const bool* __restrict__ valid, const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ slots, T* __restrict__ cot,
                          T* __restrict__ va, T* __restrict__ k_vecs,
                          T* __restrict__ vertex_areas, int n, int64_t nv) {
  __shared__ T s_val[kRowThreads * kSumStride];
  const int64_t member = blockIdx.y;
  pos += member * nv * 3;
  cot += member * 3 * (int64_t)n;
  va += member * 3 * (int64_t)n;
  k_vecs += member * nv * 3;
  vertex_areas += member * nv;
  const int64_t row = ((int64_t)blockIdx.x * kRowThreads + threadIdx.x) / kRowLanes;
  const int lane = threadIdx.x % kRowLanes;
  const int base = threadIdx.x - lane;  // the group's first lane in the block
  const unsigned mask = ((1u << kRowLanes) - 1) << (base % 32);
  int lo = 0, hi = 0;  // no slots past the last row: every lane of a group loops alike
  if (row < nv) {
    lo = offsets[row];
    hi = offsets[row + 1];
  }
  T sum = T(0);  // lane i < 4: k.x, k.y, k.z, area
  for (int first = lo; first < hi; first += kRowLanes) {
    V3<T> kc = {T(0), T(0), T(0)};
    T ac = T(0);
    if (first + lane < hi) {
      const int slot = slots[first + lane];
      const int t = slot / 3;
      int64_t r[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) r[i] = __ldg(rows + 3 * (int64_t)t + i);
      const bool live = valid[t];
      V3<T> x[3];
      const bool ok = gather(pos, r, nv, x);
      T wc;
      curv_corner(x, live, slot % 3, &kc, &ac, &wc);
      if (!ok) {
        const T q = nan_of<T>();
        kc = {q, q, q};
        ac = wc = q;
      }
      cot[slot] = wc;
      va[slot] = ac;
    }
    T* mine = s_val + threadIdx.x * kSumStride;
    mine[0] = kc.x;
    mine[1] = kc.y;
    mine[2] = kc.z;
    mine[3] = ac;
    __syncwarp(mask);
    if (lane < 4) {
      const int here = hi - first;
#pragma unroll
      for (int i = 0; i < kRowLanes; ++i) {
        if (i < here) sum += s_val[(base + i) * kSumStride + lane];
      }
    }
    __syncwarp(mask);
  }
  if (row < nv && lane < 4) {
    if (lane < 3) {
      k_vecs[3 * row + lane] = sum;
    } else {
      vertex_areas[row] = sum;
    }
  }
}

// ---------------------------------------------------------------------
// P1 divergence: g_i = (n x e_i) / |n|^2, div = sum_i t_i . g_i
// ---------------------------------------------------------------------
// One triangle's arithmetic, the one of every divergence form, in two parts
// (each value from the same operations on the same inputs, so the bits do not
// depend on how a member group schedules them).  The positions' part: the
// shape gradients g and the area.
template <typename T>
__device__ __forceinline__ void p1_shape(const V3<T>* v, V3<T>* g, T* area) {
  const T eps = T(kEpsArea);
  const V3<T> e[3] = {sub(v[2], v[1]), sub(v[0], v[2]), sub(v[1], v[0])};
  const V3<T> nrm = cross(e[1], e[2]);
  const T sq = dot(nrm, nrm);
  const T n_sq = sq > eps * eps ? sq : eps * eps;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const V3<T> c = cross(nrm, e[k]);
    g[k] = {c.x / n_sq, c.y / n_sq, c.z / n_sq};
  }
  *area = T(0.5) * sqrt(sq > T(0) ? sq : T(0));
}

// The tilts' part: div = ((0 + t_0 . g_0) + t_1 . g_1) + t_2 . g_2.
template <typename T>
__device__ __forceinline__ T p1_div_of(const V3<T>* tc, const V3<T>* g) {
  T d = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) d = d + dot(tc[k], g[k]);
  return d;
}

// One launch of the divergence kernel.  ``pos_stride`` / ``tilt_stride``:
// values between two members' positions / tilts, 0 where one array is shared
// by the members.  ``div`` (members, n); ``area`` and ``grads`` (members, n)
// and (members, n, 3, 3), or one member's (n,) and (n, 3, 3) where the
// positions are shared (every member's would be the same bits); ``grads``
// null: g is not written (kG false).
template <typename T>
struct P1Div {
  const T* pos;
  int64_t pos_stride;
  const T* tilts;
  int64_t tilt_stride;
  const int64_t* rows;
  const bool* valid;
  T* div;
  T* area;
  T* grads;
  int n;
  int64_t nv;
  int members;
};

// Block (x, y): the tile x of kTile triangles for the group of members
// y * kM .. y * kM + kM - 1 (the last group may hold fewer).  The block
// reads the tile's rows and the mask once for the group and issues the
// group's corner loads together (a shared positions or tilts array once);
// each member's div, area and g are p1_shape and p1_div_of of its own
// corners, so member m is the bits of a call on it alone.  div zeroed on
// invalid triangles and the area where the triangle is invalid or 2 * area
// < EPS_AREA (tilt_ops.mask_divergence); g unmasked; a row out of range: NaN
// outputs.
// kG: each member's g staged in shared memory and stored as a slab.
template <typename T, bool kG, int kM>
__global__ void __launch_bounds__(kTile) p1_div_kernel(const P1Div<T> a) {
  __shared__ alignas(16) int64_t s_rows[3 * kTile];
  __shared__ alignas(16) T s_g[kG ? 9 * kTile : 2];
  const int64_t first_member = (int64_t)blockIdx.y * kM;
  const int here_m = a.members - first_member < kM ? (int)(a.members - first_member) : kM;
  const bool shared_pos = a.pos_stride == 0;
  const bool shared_tilts = a.tilt_stride == 0;
  const int64_t nv = a.nv;
  const int n = a.n;
  const T* __restrict__ pos = a.pos + first_member * a.pos_stride;
  const T* __restrict__ tilts = a.tilts + first_member * a.tilt_stride;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kTile;
  const int here = min(kTile, n - first);
  load_rows(a.rows, first, here, s_rows);

  // the rows once, then every member's corners: a shared array's once
  const bool live = tid < here;
  const int t = first + tid;
  bool ok = live;
  int64_t r[3] = {0, 0, 0};
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r[k] = s_rows[3 * tid + k];
      if (r[k] < 0 || r[k] >= nv) {
        ok = false;
        r[k] = 0;
      }
    }
  }
  V3<T> v[kM][3], tc[kM][3];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const bool load_v = ok && m < here_m && (m == 0 || !shared_pos);
    const bool load_t = ok && m < here_m && (m == 0 || !shared_tilts);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T* x = pos + m * a.pos_stride + 3 * r[k];
      const T* y = tilts + m * a.tilt_stride + 3 * r[k];
      v[m][k] = load_v ? V3<T>{__ldg(x), __ldg(x + 1), __ldg(x + 2)} : V3<T>{T(0), T(0), T(0)};
      tc[m][k] = load_t ? V3<T>{__ldg(y), __ldg(y + 1), __ldg(y + 2)} : V3<T>{T(0), T(0), T(0)};
    }
  }
  const bool counted = live && a.valid[t];

  V3<T> g[3];
  T ar = T(0);
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    if (m >= here_m) break;  // the same for the whole block
    const int64_t member = first_member + m;
    // g and the area of this member's positions (of every member's where shared)
    const bool own = !shared_pos || member == 0;
    if (m == 0 || !shared_pos) p1_shape(v[m], g, &ar);
    V3<T> g_out[3] = {g[0], g[1], g[2]};
    if (live) {
      // this member's tilts (member 0's where shared), by selects: no indexed local array
      const V3<T> t3[3] = {shared_tilts ? tc[0][0] : tc[m][0], shared_tilts ? tc[0][1] : tc[m][1],
                           shared_tilts ? tc[0][2] : tc[m][2]};
      T d = p1_div_of(t3, g);
      d = counted ? d : T(0);
      T am = (counted && T(2) * ar >= T(kEpsArea)) ? ar : T(0);
      if (!ok) {
        const T q = nan_of<T>();
        const V3<T> qv = {q, q, q};
        d = am = q;
        g_out[0] = g_out[1] = g_out[2] = qv;
      }
      a.div[member * n + t] = d;
      if (own) a.area[(shared_pos ? 0 : member) * n + t] = am;
    }
    if constexpr (kG) {
      if (own) {
        if (m > 0) __syncthreads();  // the last member's slab stores have read s_g
        if (live) put_corners(s_g, tid, g_out);
        __syncthreads();
        store_slab(a.grads + (shared_pos ? 0 : member) * 9 * (int64_t)n + 9 * (int64_t)first,
                   s_g, 9 * here);
      }
    }
  }
}

// Grids over n triangles: the per-triangle curvature kernels' (one member),
// the tiles' with ``members`` stacked members on the y axis.
inline dim3 blocks_for(int n) { return dim3((unsigned int)((n + kThreads - 1) / kThreads)); }
// Grids over nv vertex rows of kRowLanes lanes each, members on the y axis.
inline dim3 row_groups_for(int64_t nv, int members) {
  constexpr int64_t kRows = kRowThreads / kRowLanes;
  return dim3((unsigned int)((nv + kRows - 1) / kRows), (unsigned int)members);
}
inline dim3 tiles_for(int n, int members = 1) {
  return dim3((unsigned int)((n + kTile - 1) / kTile), (unsigned int)members);
}

// The largest group of members a block of the surface kernel takes.
constexpr int kMaxGroup = 4;
// The largest group of members a block of the divergence kernel takes.
constexpr int kMaxDivGroup = 4;

template <typename T, bool kG, int kM>
void p1_div_group(const P1Div<T>& a, cudaStream_t st) {
  const dim3 grid((unsigned int)((a.n + kTile - 1) / kTile),
                  (unsigned int)((a.members + kM - 1) / kM));
  p1_div_kernel<T, kG, kM><<<grid, kTile, 0, st>>>(a);
}

// The divergence kernel in groups of ``group`` members, g written where
// ``grads`` is not null.  cudaErrorInvalidValue for another group.
template <typename T>
int p1_div(const P1Div<T>& a, int group, cudaStream_t st) {
  const bool g = a.grads != nullptr;
  switch (group) {
    case 1: g ? p1_div_group<T, true, 1>(a, st) : p1_div_group<T, false, 1>(a, st); break;
    case 2: g ? p1_div_group<T, true, 2>(a, st) : p1_div_group<T, false, 2>(a, st); break;
    case 3: g ? p1_div_group<T, true, 3>(a, st) : p1_div_group<T, false, 3>(a, st); break;
    case 4: g ? p1_div_group<T, true, 4>(a, st) : p1_div_group<T, false, 4>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kGrad, int kM>
void surface_group(const Surface<T>& a, cudaStream_t st) {
  const dim3 grid((unsigned int)((a.n + kTile - 1) / kTile),
                  (unsigned int)((a.members + kM - 1) / kM));
  surface_kernel<T, kGrad, kM><<<grid, kTile, 0, st>>>(a);
}

template <typename T, bool kGrad>
bool surface_groups(const Surface<T>& a, int group, cudaStream_t st) {
  switch (group) {
    case 1: surface_group<T, kGrad, 1>(a, st); break;
    case 2: surface_group<T, kGrad, 2>(a, st); break;
    case 3: surface_group<T, kGrad, 3>(a, st); break;
    case 4: surface_group<T, kGrad, 4>(a, st); break;
    default: return false;
  }
  return true;
}

// The surface kernel in groups of ``group`` members and, with the gradient
// and the CSR, the vertex sum of each member's rows (the boundary ones with
// the tables).  cudaErrorInvalidValue for another group.
template <typename T>
int surface(const Surface<T>& a, bool grad, int group, cudaStream_t st) {
  const bool launched = grad ? surface_groups<T, true>(a, group, st)
                             : surface_groups<T, false>(a, group, st);
  if (!launched) return (int)cudaErrorInvalidValue;
  if (grad && a.offsets != nullptr) {
    vertex_sum::launch<T, 3>(a.offsets, a.slots, a.dc, a.dpos, nullptr, nullptr, (int)a.nv, st,
                             a.members, 3 * (int64_t)a.n, a.interior);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  ``f64`` selects double (1) or
// float (0) for every floating-point pointer.  Each launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

// Triangles per block of the surface and divergence kernels, for the
// caller's partials buffer and its 16-byte alignment checks.
extern "C" int tri_tile_size() { return kTile; }

// Per-triangle energies e (T,) and corner gradients (T, 3, 3), no mask.
extern "C" int tri_surface_fwd(int f64, const void* pos, const int64_t* rows, const void* gamma,
                               void* energy, void* grads, int n, int64_t nv, void* stream) {
  if (n < 1) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    const Surface<double> a{(const double*)pos, rows, nullptr, (const double*)gamma, 0,
                            (double*)energy, (double*)grads, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n, nv, 1};
    return surface(a, true, 1, st);
  }
  const Surface<float> a{(const float*)pos, rows, nullptr, (const float*)gamma, 0,
                         (float*)energy, (float*)grads, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n, nv, 1};
  return surface(a, true, 1, st);
}

namespace {

template <typename T>
int surface_energy(const void* pos, const int64_t* rows, const bool* valid,
                   const void* tension, int64_t tension_stride, const int32_t* offsets,
                   const int32_t* slots, const int32_t* tile_vertices,
                   const int32_t* tile_offsets, const uint8_t* corner_mask,
                   const uint8_t* interior, void* dc_scratch, double* partials,
                   unsigned int* counter, void* energy, void* dpos, int n, int64_t nv, int grad,
                   int members, int group, cudaStream_t st) {
  const Surface<T> a{(const T*)pos, rows, valid, (const T*)tension, tension_stride, nullptr,
                     (T*)dc_scratch, offsets, slots, tile_vertices, tile_offsets, corner_mask,
                     interior, (T*)dpos, partials, counter, (T*)energy, n, nv, members};
  return surface(a, grad != 0, group, st);
}

}  // namespace

// The surface energy sum_t [valid_t] tension_t A_t into energy (1,) and,
// with ``grad``, its gradient dpos (Nv, 3) summed over the corner CSR
// (offsets (Nv + 1,), slots (3T,)) from the (T, 3, 3) dc_scratch, every
// corner through it (one member: a launch of one wave, which the in-tile
// sums would lengthen).  partials holds one double per block of
// tri_tile_size() triangles, counter one zeroed uint32 (left at zero).
// cudaErrorInvalidValue for n < 1.
extern "C" int tri_surface_energy(int f64, const void* pos, const int64_t* rows,
                                  const bool* valid, const void* tension, const int32_t* offsets,
                                  const int32_t* slots, void* dc_scratch, double* partials,
                                  unsigned int* counter, void* energy, void* dpos, int n,
                                  int64_t nv, int grad, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const auto fn = f64 ? surface_energy<double> : surface_energy<float>;
  return fn(pos, rows, valid, tension, 0, offsets, slots, nullptr, nullptr, nullptr, nullptr,
            dc_scratch, partials, counter, energy, dpos, n, nv, grad, 1, 1,
            (cudaStream_t)stream);
}

// The member axis: ``members`` stacked members in one call, ``group``
// members a block (1 to tri_surface_max_group(); the last group may hold
// fewer): pos (members, nv, 3), tension (members, n) with tension_stride n
// or one shared (n,) with tension_stride 0, partials (members,
// tri_tile_size() blocks), counter (one zeroed uint32 a group, left at
// zero), energy (members,); with ``grad``, dpos (members, nv, 3),
// dc_scratch (members, n, 3, 3) and either the tile tables of the corner
// CSR (kernels/vertex_sum.tile_sums: tile_vertices, tile_offsets,
// corner_mask, interior; only the boundary corners' rows then go through
// the scratch) or none (null: every corner through it).  rows,
// valid, the CSR and the tables are shared.  Member m's outputs are the
// bits of tri_surface_energy on member m alone, at any group.
// cudaErrorInvalidValue for n < 1, members < 1 or another group.
extern "C" int tri_surface_energy_members(int f64, const void* pos, const int64_t* rows,
                                          const bool* valid, const void* tension,
                                          int64_t tension_stride, const int32_t* offsets,
                                          const int32_t* slots, const int32_t* tile_vertices,
                                          const int32_t* tile_offsets,
                                          const uint8_t* corner_mask, const uint8_t* interior,
                                          void* dc_scratch, double* partials,
                                          unsigned int* counter, void* energy, void* dpos, int n,
                                          int64_t nv, int grad, int members, int group,
                                          void* stream) {
  if (n < 1 || members < 1) return (int)cudaErrorInvalidValue;
  const auto fn = f64 ? surface_energy<double> : surface_energy<float>;
  return fn(pos, rows, valid, tension, tension_stride, offsets, slots, tile_vertices,
            tile_offsets, corner_mask, interior, dc_scratch, partials, counter, energy, dpos, n,
            nv, grad, members, group, (cudaStream_t)stream);
}

// The largest ``group`` tri_surface_energy_members takes.
extern "C" int tri_surface_max_group() { return kMaxGroup; }

extern "C" int tri_curvature_fwd(int f64, const void* pos, const int64_t* rows, const bool* valid,
                                 void* cot, void* kv, void* va, void* tri_area, int n, int64_t nv,
                                 void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (f64) {
      curvature_fwd_kernel<double><<<blocks_for(n), kThreads, 0, st>>>(
          (const double*)pos, rows, valid, (double*)cot, (double*)kv, (double*)va,
          (double*)tri_area, n, nv);
    } else {
      curvature_fwd_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
          (const float*)pos, rows, valid, (float*)cot, (float*)kv, (float*)va, (float*)tri_area,
          n, nv);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int tri_curvature_bwd(int f64, const void* pos, const int64_t* rows, const bool* valid,
                                 const void* g_cot, const void* g_kv, const void* g_va,
                                 const void* g_area, void* dp, int n, int64_t nv, void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (f64) {
      curvature_bwd_kernel<double><<<tiles_for(n), kTile, 0, st>>>(
          (const double*)pos, rows, valid, (const double*)g_cot, (const double*)g_kv,
          (const double*)g_va, (const double*)g_area, nullptr, nullptr, (double*)dp, n, nv);
    } else {
      curvature_bwd_kernel<float><<<tiles_for(n), kTile, 0, st>>>(
          (const float*)pos, rows, valid, (const float*)g_cot, (const float*)g_kv,
          (const float*)g_va, (const float*)g_area, nullptr, nullptr, (float*)dp, n, nv);
    }
  }
  return (int)cudaGetLastError();
}

namespace {

// One launch: a lane group per vertex row, ``members`` stacked members on
// the grid's y axis.  Nothing for nv = 0.
template <typename T>
void curvature_data(const T* pos, const int64_t* rows, const bool* valid, const int32_t* offsets,
                    const int32_t* slots, T* cot, T* va, T* k_vecs, T* vertex_areas, int n,
                    int64_t nv, cudaStream_t st, int members = 1) {
  if (nv < 1) return;
  curvature_data_kernel<T><<<row_groups_for(nv, members), kRowThreads, 0, st>>>(
      pos, rows, valid, offsets, slots, cot, va, k_vecs, vertex_areas, n, nv);
}

// Two launches: the corner gradients into dc_scratch (T, 3, 3) per member,
// then the vertex sum.
template <typename T>
void curvature_data_bwd(const T* pos, const int64_t* rows, const bool* valid,
                        const int32_t* offsets, const int32_t* slots, const T* g_kvecs,
                        const T* g_varea, const T* g_cot, const T* g_va, T* dc_scratch, T* dpos,
                        int n, int64_t nv, cudaStream_t st, int members = 1) {
  if (n > 0) {
    curvature_bwd_kernel<T><<<tiles_for(n, members), kTile, 0, st>>>(
        pos, rows, valid, g_cot, nullptr, g_va, nullptr, g_kvecs, g_varea, dc_scratch, n, nv);
  }
  vertex_sum::launch<T, 3>(offsets, slots, dc_scratch, dpos, nullptr, nullptr, (int)nv, st,
                           members, 3 * (int64_t)n);
}

}  // namespace

// Cotan curvature data in one launch: cot (T, 3) and va (T, 3) per corner,
// k_vecs (Nv, 3) and vertex_areas (Nv,) summed over the corner CSR
// (offsets (Nv + 1,), slots (3T,): every slot listed once, so each cot and
// va entry has one writer).
extern "C" int tri_curvature_data(int f64, const void* pos, const int64_t* rows,
                                  const bool* valid, const int32_t* offsets,
                                  const int32_t* slots, void* cot, void* va, void* k_vecs,
                                  void* vertex_areas, int n, int64_t nv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    curvature_data<double>((const double*)pos, rows, valid, offsets, slots, (double*)cot,
                           (double*)va, (double*)k_vecs, (double*)vertex_areas, n, nv, st);
  } else {
    curvature_data<float>((const float*)pos, rows, valid, offsets, slots, (float*)cot,
                          (float*)va, (float*)k_vecs, (float*)vertex_areas, n, nv, st);
  }
  return (int)cudaGetLastError();
}

// Its backward: dpos (Nv, 3) from the upstream of k_vecs (Nv, 3),
// vertex_areas (Nv,), cot (T, 3) and va (T, 3), any of them null;
// dc_scratch is (T, 3, 3).
extern "C" int tri_curvature_data_bwd(int f64, const void* pos, const int64_t* rows,
                                      const bool* valid, const int32_t* offsets,
                                      const int32_t* slots, const void* g_kvecs,
                                      const void* g_varea, const void* g_cot, const void* g_va,
                                      void* dc_scratch, void* dpos, int n, int64_t nv,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    curvature_data_bwd<double>((const double*)pos, rows, valid, offsets, slots,
                               (const double*)g_kvecs, (const double*)g_varea,
                               (const double*)g_cot, (const double*)g_va, (double*)dc_scratch,
                               (double*)dpos, n, nv, st);
  } else {
    curvature_data_bwd<float>((const float*)pos, rows, valid, offsets, slots,
                              (const float*)g_kvecs, (const float*)g_varea, (const float*)g_cot,
                              (const float*)g_va, (float*)dc_scratch, (float*)dpos, n, nv, st);
  }
  return (int)cudaGetLastError();
}

namespace {

template <typename T>
int p1_divergence(const void* pos, int64_t pos_stride, const void* tilts, int64_t tilt_stride,
                  const int64_t* rows, const bool* valid, void* div, void* area, void* grads,
                  int n, int64_t nv, int members, int group, cudaStream_t st) {
  const P1Div<T> a{(const T*)pos, pos_stride, (const T*)tilts, tilt_stride, rows, valid,
                   (T*)div, (T*)area, (T*)grads, n, nv, members};
  return p1_div(a, group, st);
}

}  // namespace

// div (T,), area (T,) and, where ``grads`` is not null, g (T, 3, 3) of
// tilt_ops.p1_triangle_divergence, masked as it masks them: the one-member
// case of tri_p1_div_members.
extern "C" int tri_p1_div(int f64, const void* pos, const void* tilts, const int64_t* rows,
                          const bool* valid, void* div, void* area, void* grads, int n,
                          int64_t nv, void* stream) {
  if (n < 1) return (int)cudaGetLastError();
  const auto fn = f64 ? p1_divergence<double> : p1_divergence<float>;
  return fn(pos, 3 * nv, tilts, 3 * nv, rows, valid, div, area, grads, n, nv, 1, 1,
            (cudaStream_t)stream);
}

// The tilt gradient of <g_div, div>: dtilts (Nv, 3), row v the sum over its
// CSR slots (t, c) of [valid_t] g_div_t g[t, c], from the forward's g: the
// one-member case of tri_p1_div_bwd_members.
extern "C" int tri_p1_div_bwd(int f64, const int32_t* offsets, const int32_t* slots,
                              const void* grads, const bool* valid, const void* g_div,
                              void* dtilts, int64_t nv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok = f64 ? vertex_sum::launch_weighted<double, 3>(
                            offsets, slots, (const double*)grads, 0, (const double*)g_div, 0,
                            valid, (double*)dtilts, (int)nv, st)
                      : vertex_sum::launch_weighted<float, 3>(
                            offsets, slots, (const float*)grads, 0, (const float*)g_div, 0,
                            valid, (float*)dtilts, (int)nv, st);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// the member axis (the parameter sweep): ``members`` stacked members in
// one call, the members on the grids' y axis; per member the positions
// (and tilts) (members, nv, 3), every upstream and output with a leading
// member axis, the scratch too; tri_rows, the masks and the CSR shared.
// Member m's outputs are the bits of the call above on member m alone.
// ---------------------------------------------------------------------

extern "C" int tri_curvature_data_members(int f64, const void* pos, const int64_t* rows,
                                          const bool* valid, const int32_t* offsets,
                                          const int32_t* slots, void* cot, void* va,
                                          void* k_vecs, void* vertex_areas, int n, int64_t nv,
                                          int members, void* stream) {
  if (members < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    curvature_data<double>((const double*)pos, rows, valid, offsets, slots, (double*)cot,
                           (double*)va, (double*)k_vecs, (double*)vertex_areas, n, nv, st,
                           members);
  } else {
    curvature_data<float>((const float*)pos, rows, valid, offsets, slots, (float*)cot,
                          (float*)va, (float*)k_vecs, (float*)vertex_areas, n, nv, st, members);
  }
  return (int)cudaGetLastError();
}

extern "C" int tri_curvature_data_bwd_members(int f64, const void* pos, const int64_t* rows,
                                              const bool* valid, const int32_t* offsets,
                                              const int32_t* slots, const void* g_kvecs,
                                              const void* g_varea, const void* g_cot,
                                              const void* g_va, void* dc_scratch, void* dpos,
                                              int n, int64_t nv, int members, void* stream) {
  if (members < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    curvature_data_bwd<double>((const double*)pos, rows, valid, offsets, slots,
                               (const double*)g_kvecs, (const double*)g_varea,
                               (const double*)g_cot, (const double*)g_va, (double*)dc_scratch,
                               (double*)dpos, n, nv, st, members);
  } else {
    curvature_data_bwd<float>((const float*)pos, rows, valid, offsets, slots,
                              (const float*)g_kvecs, (const float*)g_varea, (const float*)g_cot,
                              (const float*)g_va, (float*)dc_scratch, (float*)dpos, n, nv, st,
                              members);
  }
  return (int)cudaGetLastError();
}

// ``members`` stacked members, ``group`` members a block over one tile (1 to
// tri_p1_div_max_group(); the last group may hold fewer): pos and tilts
// (members, nv, 3) with ``pos_shared`` / ``tilts_shared`` 0, or one (nv, 3)
// array shared by the members with 1; div (members, n); area (members, n) and
// grads (members, n, 3, 3), or (n,) and (n, 3, 3) with shared positions
// (every member's are the same); grads null: g is not written.  Member m's
// outputs are the bits of tri_p1_div on member m alone, at any group.
// cudaErrorInvalidValue for members < 1 or another group.
extern "C" int tri_p1_div_members(int f64, const void* pos, int pos_shared, const void* tilts,
                                  int tilts_shared, const int64_t* rows, const bool* valid,
                                  void* div, void* area, void* grads, int n, int64_t nv,
                                  int members, int group, void* stream) {
  if (members < 1) return (int)cudaErrorInvalidValue;
  if (n < 1) return (int)cudaGetLastError();
  const auto fn = f64 ? p1_divergence<double> : p1_divergence<float>;
  return fn(pos, pos_shared ? 0 : 3 * nv, tilts, tilts_shared ? 0 : 3 * nv, rows, valid, div,
            area, grads, n, nv, members, group, (cudaStream_t)stream);
}

// The largest ``group`` tri_p1_div_members takes.
extern "C" int tri_p1_div_max_group() { return kMaxDivGroup; }

// grads (members, n, 3, 3), or one (n, 3, 3) shared by the members with
// ``grads_shared`` 1; g_div (members, n), dtilts (members, nv, 3); ``group``
// members a thread (1 to tri_p1_div_bwd_max_group()).  Member m's rows are
// the bits of tri_p1_div_bwd on member m alone, at any group.
extern "C" int tri_p1_div_bwd_members(int f64, const int32_t* offsets, const int32_t* slots,
                                      const void* grads, int grads_shared, const bool* valid,
                                      const void* g_div, void* dtilts, int64_t nv, int n,
                                      int members, int group, void* stream) {
  if (members < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t src_stride = grads_shared ? 0 : 9 * (int64_t)n;
  const bool ok = f64 ? vertex_sum::launch_weighted<double, 3>(
                            offsets, slots, (const double*)grads, src_stride,
                            (const double*)g_div, n, valid, (double*)dtilts, (int)nv, st, members,
                            group)
                      : vertex_sum::launch_weighted<float, 3>(
                            offsets, slots, (const float*)grads, src_stride,
                            (const float*)g_div, n, valid, (float*)dtilts, (int)nv, st, members,
                            group);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// The largest ``group`` tri_p1_div_bwd_members takes.
extern "C" int tri_p1_div_bwd_max_group() { return vertex_sum::kMaxWeightedGroup; }
