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
// tri_surface_fwd and tri_curvature_fwd / tri_curvature_bwd run the same
// kernels with per-triangle outputs and no sums (the tests and the card
// checks).  Every kernel gathers its corners from the (Nv, 3)
// positions (and tilts) through the (T, 3) int64 tri_rows itself and writes
// per-triangle rows in the layout of the JAX functions (corner vectors as
// (T, 3, 3), index corner * 3 + xyz).  A row index outside [0, Nv) makes that
// triangle's outputs NaN instead of reading out of bounds.
//
// The whole calls, with no atomics on a float: the vertex sums go through the
// vertex-sum kernel (vertex_sum.cuh) in the order of the topology's corner
// CSR, and the surface energy through a last-block sum of double partials
// (block_sum.cuh), so every call gives the same bits on every run.
// - tri_surface_energy: the surface kernel reads tri_valid and the tension
//   itself, sums the energy into one scalar and, with the gradient, writes
//   the corner gradients +dE/dv to a (T, 3, 3) scratch that stays in L2; the
//   vertex-sum kernel adds them into (Nv, 3).
// - tri_curvature_data: the curvature kernel writes the cotangents and Meyer
//   corner areas (outputs) and the corner mean-curvature vectors (scratch);
//   the vertex-sum kernel adds the vectors and areas into k_vecs (Nv, 3) and
//   vertex_areas (Nv,).  Its backward kernel reads the vertex upstream
//   through tri_rows itself and writes corner gradients to a scratch that
//   the vertex-sum kernel adds into (Nv, 3).  Any upstream may be null.
// - tri_p1_div: div zeroed on invalid triangles, the area zeroed where the
//   triangle is invalid or below the area floor, and the P1 shape gradients
//   g (T, 3, 3).  tri_p1_div_bwd: dE/dt_v = sum over the CSR slots (t, c) of
//   v of [valid_t] dE/ddiv_t g[t, c], the weighted vertex sum, one launch.
//
// The arithmetic follows the plain twins in device/geo.py and
// device/tilt_ops.py operation by operation; the file is built with
// -fmad=false so that no multiply-add is contracted, which keeps the Meyer
// obtuse-branch tests (c < 0) on the same side as the twin's where the
// cotangent sits at a tie (the right triangles of a refined cube).
//
// What bounds them on an H100: bytes, then latency.  Counted at the kozlov
// L3 lane (Nv = 10,817, T = 21,504, float32), each call's own inputs read
// once and outputs written once (the corner CSR, which another scatter
// design would not need, not counted):
// - surface energy 0.75 MB (positions 0.13, int64 tri_rows 0.52, the mask,
//   the tension), 0.225 us at 3.35 TB/s; with the vertex gradient 0.88 MB,
//   0.264 us;
// - P1 divergence 1.74 MB (positions, tilts, tri_rows, the mask in; div,
//   area, g out), 0.520 us; its tilt backward 1.01 MB (g, the mask, the
//   upstream in, (Nv, 3) out), 0.302 us;
// - curvature data 1.36 MB, 0.405 us; its backward 0.97 MB, 0.290 us.
// Some 60-140 flops per triangle (320 in the curvature backward), far below
// either peak.  So the surface and divergence kernels are laid out for the
// memory system: 128 triangles per block (168 blocks at L3, work on every
// one of the 132 SMs); the block's 3,072-byte tri_rows slab is loaded into
// shared memory as 16-byte vectors, then the corners are gathered through
// L2 with __ldg (positions and tilts are 0.13 MB each); the (T, 3, 3)
// outputs are staged in shared memory and written as contiguous 16-byte
// stores instead of nine 36-byte-strided scalar stores per thread.  The
// curvature kernels keep one thread per triangle in 256-thread blocks; the
// backward recomputes the forward in registers rather than reading saved
// intermediates, which trades ~100 flops for ~200 bytes per triangle.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_sum.cuh"
#include "vertex_sum.cuh"

namespace {

constexpr int kThreads = 256;  // curvature kernels: threads (triangles) per block
constexpr int kTile = 128;     // surface and divergence kernels: triangles per block
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

// ``n`` values from shared ``src`` to global ``dst`` (both 16-byte aligned)
// by the whole block as coalesced 16-byte stores; the last values past a
// 16-byte multiple plainly.
template <typename T>
__device__ __forceinline__ void store_slab(T* __restrict__ dst, const T* src, int n) {
  constexpr int kVec = 16 / sizeof(T);
  const int n16 = n / kVec;
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

// ``valid`` null: every triangle counts.  ``e_tri`` non-null: the
// per-triangle energies.  kGrad: the corner gradients to ``dc`` (T, 3, 3).
// ``partials`` non-null: the energies summed into energy[0] (block_sum.cuh).
template <typename T, bool kGrad>
__global__ void __launch_bounds__(kTile)
    surface_kernel(const T* __restrict__ pos, const int64_t* __restrict__ rows,
                   const bool* __restrict__ valid, const T* __restrict__ gamma,
                   T* __restrict__ e_tri, T* __restrict__ dc, double* __restrict__ partials,
                   unsigned int* __restrict__ counter, T* __restrict__ energy, int n, int64_t nv) {
  __shared__ alignas(16) int64_t s_rows[3 * kTile];
  __shared__ alignas(16) T s_dc[kGrad ? 9 * kTile : 4];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kTile;
  const int here = min(kTile, n - first);
  load_rows(rows, first, here, s_rows);

  double e_thread = 0.0;
  if (tid < here) {
    const int t = first + tid;
    V3<T> v[3], d[3];
    const bool ok = gather(pos, s_rows + 3 * tid, nv, v);
    const T g = (valid == nullptr || valid[t]) ? gamma[t] : T(0);
    T e = surface_terms(v, g, d);
    if (!ok) {
      const T q = nan_of<T>();
      const V3<T> qv = {q, q, q};
      e = q;
      d[0] = d[1] = d[2] = qv;
    }
    if (e_tri != nullptr) e_tri[t] = e;
    e_thread = (double)e;
    if constexpr (kGrad) put_corners(s_dc, tid, d);
  }
  if constexpr (kGrad) {
    __syncthreads();
    store_slab(dc + 9 * (int64_t)first, s_dc, 9 * here);
  }
  if (partials != nullptr) {
    double total;
    if (block_sum::grid_sum<kTile>(e_thread, partials, counter, &total)) energy[0] = (T)total;
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
    if (tri_area) tri_area[t] = q;
    return;
  }
  const Curv<T> s = curv_of(v);
  const T m = valid[t] ? T(1) : T(0);
  const T half = T(0.5);
  store(kv, 3 * t + 0, scale(m, scale(half, add(scale(s.c1, neg(s.e1)), scale(s.c2, s.e2)))));
  store(kv, 3 * t + 1, scale(m, scale(half, add(scale(s.c2, neg(s.e2)), scale(s.c0, s.e0)))));
  store(kv, 3 * t + 2, scale(m, scale(half, add(scale(s.c0, neg(s.e0)), scale(s.c1, s.e1)))));

  const T area = half * s.dbl;
  const bool any_obt = s.obt0 || s.obt1 || s.obt2;
  T a0 = !any_obt ? (s.l1 * s.c1 + s.l2 * s.c2) / T(8) : T(0);
  T a1 = !any_obt ? (s.l2 * s.c2 + s.l0 * s.c0) / T(8) : T(0);
  T a2 = !any_obt ? (s.l0 * s.c0 + s.l1 * s.c1) / T(8) : T(0);
  if (s.obt0) a0 = area / T(2);
  if (s.obt1 || s.obt2) a0 = area / T(4);
  if (s.obt1) a1 = area / T(2);
  if (s.obt0 || s.obt2) a1 = area / T(4);
  if (s.obt2) a2 = area / T(2);
  if (s.obt0 || s.obt1) a2 = area / T(4);
  va[3 * t + 0] = a0 * m;
  va[3 * t + 1] = a1 * m;
  va[3 * t + 2] = a2 * m;
  cot[3 * t + 0] = s.c0 * m;
  cot[3 * t + 1] = s.c1 * m;
  cot[3 * t + 2] = s.c2 * m;
  if (tri_area) tri_area[t] = area;
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

// g_cot, g_kv (T, 3, 3), g_va, g_area: per-triangle upstreams; g_kvecs
// (Nv, 3) and g_varea (Nv,): upstreams of the vertex sums of the corner
// vectors and corner areas.  Each may be null.
template <typename T>
__global__ void curvature_bwd_kernel(const T* __restrict__ pos, const int64_t* __restrict__ rows,
                                     const bool* __restrict__ valid, const T* __restrict__ g_cot,
                                     const T* __restrict__ g_kv, const T* __restrict__ g_va,
                                     const T* __restrict__ g_area, const T* __restrict__ g_kvecs,
                                     const T* __restrict__ g_varea, T* __restrict__ dp, int n,
                                     int64_t nv) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  V3<T> v[3];
  if (!load_corners(pos, rows, t, nv, v)) {
    const T q = nan_of<T>();
    for (int i = 0; i < 9; ++i) dp[9 * t + i] = q;
    return;
  }
  const Curv<T> s = curv_of(v);
  const T m = valid[t] ? T(1) : T(0);
  const T half = T(0.5);
  const int64_t r0 = rows[3 * t], r1 = rows[3 * t + 1], r2 = rows[3 * t + 2];
  const int64_t k0 = 9 * (int64_t)t;
  const V3<T> gk0 = {upstream(g_kv, k0 + 0, g_kvecs, 3 * r0), upstream(g_kv, k0 + 1, g_kvecs, 3 * r0 + 1),
                     upstream(g_kv, k0 + 2, g_kvecs, 3 * r0 + 2)};
  const V3<T> gk1 = {upstream(g_kv, k0 + 3, g_kvecs, 3 * r1), upstream(g_kv, k0 + 4, g_kvecs, 3 * r1 + 1),
                     upstream(g_kv, k0 + 5, g_kvecs, 3 * r1 + 2)};
  const V3<T> gk2 = {upstream(g_kv, k0 + 6, g_kvecs, 3 * r2), upstream(g_kv, k0 + 7, g_kvecs, 3 * r2 + 1),
                     upstream(g_kv, k0 + 8, g_kvecs, 3 * r2 + 2)};

  // adjoints of the cotangents, the squared lengths, the area and the edges
  T gc0 = (g_cot ? g_cot[3 * t + 0] : T(0)) * m;
  T gc1 = (g_cot ? g_cot[3 * t + 1] : T(0)) * m;
  T gc2 = (g_cot ? g_cot[3 * t + 2] : T(0)) * m;
  T gl0 = T(0), gl1 = T(0), gl2 = T(0);
  T gA = g_area ? g_area[t] : T(0);
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
  const T gva0 = upstream(g_va, 3 * (int64_t)t + 0, g_varea, r0) * m;
  const T gva1 = upstream(g_va, 3 * (int64_t)t + 1, g_varea, r1) * m;
  const T gva2 = upstream(g_va, 3 * (int64_t)t + 2, g_varea, r2) * m;
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
  store(dp, 3 * t + 0, sub(ge1, ge2));
  store(dp, 3 * t + 1, sub(ge2, ge0));
  store(dp, 3 * t + 2, sub(ge0, ge1));
}

// ---------------------------------------------------------------------
// P1 divergence: g_i = (n x e_i) / |n|^2, div = sum_i t_i . g_i
// ---------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T p1_terms(const V3<T>* v, const V3<T>* tc, V3<T>* g, T* area) {
  const T eps = T(kEpsArea);
  const V3<T> e[3] = {sub(v[2], v[1]), sub(v[0], v[2]), sub(v[1], v[0])};
  const V3<T> nrm = cross(e[1], e[2]);
  const T sq = dot(nrm, nrm);
  const T n_sq = sq > eps * eps ? sq : eps * eps;
  T d = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const V3<T> c = cross(nrm, e[k]);
    g[k] = {c.x / n_sq, c.y / n_sq, c.z / n_sq};
    d = d + dot(tc[k], g[k]);
  }
  *area = T(0.5) * sqrt(sq > T(0) ? sq : T(0));
  return d;
}

// div zeroed on invalid triangles and the area where the triangle is
// invalid or 2 * area < EPS_AREA (tilt_ops.mask_divergence); g unmasked.
template <typename T>
__global__ void __launch_bounds__(kTile)
    p1_div_kernel(const T* __restrict__ pos, const T* __restrict__ tilts,
                  const int64_t* __restrict__ rows, const bool* __restrict__ valid,
                  T* __restrict__ div, T* __restrict__ area, T* __restrict__ grads, int n,
                  int64_t nv) {
  __shared__ alignas(16) int64_t s_rows[3 * kTile];
  __shared__ alignas(16) T s_g[9 * kTile];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kTile;
  const int here = min(kTile, n - first);
  load_rows(rows, first, here, s_rows);

  if (tid < here) {
    const int t = first + tid;
    V3<T> v[3], tc[3], g[3];
    const bool ok_v = gather(pos, s_rows + 3 * tid, nv, v);
    const bool ok_t = gather(tilts, s_rows + 3 * tid, nv, tc);
    T a;
    T d = p1_terms(v, tc, g, &a);
    const bool live = valid[t];
    d = live ? d : T(0);
    a = (live && T(2) * a >= T(kEpsArea)) ? a : T(0);
    if (!(ok_v && ok_t)) {
      const T q = nan_of<T>();
      const V3<T> qv = {q, q, q};
      d = a = q;
      g[0] = g[1] = g[2] = qv;
    }
    div[t] = d;
    area[t] = a;
    put_corners(s_g, tid, g);
  }
  __syncthreads();
  store_slab(grads + 9 * (int64_t)first, s_g, 9 * here);
}

inline unsigned int blocks_for(int n) { return (unsigned int)((n + kThreads - 1) / kThreads); }
inline unsigned int tiles_for(int n) { return (unsigned int)((n + kTile - 1) / kTile); }

template <typename T>
void surface(const T* pos, const int64_t* rows, const bool* valid, const T* gamma, T* e_tri,
             T* dc, double* partials, unsigned int* counter, T* energy, int n, int64_t nv,
             bool grad, cudaStream_t st) {
  if (grad) {
    surface_kernel<T, true><<<tiles_for(n), kTile, 0, st>>>(pos, rows, valid, gamma, e_tri, dc,
                                                           partials, counter, energy, n, nv);
  } else {
    surface_kernel<T, false><<<tiles_for(n), kTile, 0, st>>>(pos, rows, valid, gamma, e_tri,
                                                            nullptr, partials, counter, energy,
                                                            n, nv);
  }
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
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (f64) {
      surface<double>((const double*)pos, rows, nullptr, (const double*)gamma, (double*)energy,
                      (double*)grads, nullptr, nullptr, nullptr, n, nv, true, st);
    } else {
      surface<float>((const float*)pos, rows, nullptr, (const float*)gamma, (float*)energy,
                     (float*)grads, nullptr, nullptr, nullptr, n, nv, true, st);
    }
  }
  return (int)cudaGetLastError();
}

// The surface energy sum_t [valid_t] tension_t A_t into energy (1,) and,
// with ``grad``, its gradient dpos (Nv, 3) summed over the corner CSR
// (offsets (Nv + 1,), slots (3T,)) from the (T, 3, 3) dc_scratch.  partials
// holds one double per block of tri_tile_size() triangles, counter one
// zeroed uint32 (left at zero).  cudaErrorInvalidValue for n < 1.
extern "C" int tri_surface_energy(int f64, const void* pos, const int64_t* rows,
                                  const bool* valid, const void* tension, const int32_t* offsets,
                                  const int32_t* slots, void* dc_scratch, double* partials,
                                  unsigned int* counter, void* energy, void* dpos, int n,
                                  int64_t nv, int grad, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    surface<double>((const double*)pos, rows, valid, (const double*)tension, nullptr,
                    (double*)dc_scratch, partials, counter, (double*)energy, n, nv, grad, st);
    if (grad) {
      vertex_sum::launch<double, 3>(offsets, slots, (const double*)dc_scratch, (double*)dpos,
                                    nullptr, nullptr, (int)nv, st);
    }
  } else {
    surface<float>((const float*)pos, rows, valid, (const float*)tension, nullptr,
                   (float*)dc_scratch, partials, counter, (float*)energy, n, nv, grad, st);
    if (grad) {
      vertex_sum::launch<float, 3>(offsets, slots, (const float*)dc_scratch, (float*)dpos,
                                   nullptr, nullptr, (int)nv, st);
    }
  }
  return (int)cudaGetLastError();
}

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
      curvature_bwd_kernel<double><<<blocks_for(n), kThreads, 0, st>>>(
          (const double*)pos, rows, valid, (const double*)g_cot, (const double*)g_kv,
          (const double*)g_va, (const double*)g_area, nullptr, nullptr, (double*)dp, n, nv);
    } else {
      curvature_bwd_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
          (const float*)pos, rows, valid, (const float*)g_cot, (const float*)g_kv,
          (const float*)g_va, (const float*)g_area, nullptr, nullptr, (float*)dp, n, nv);
    }
  }
  return (int)cudaGetLastError();
}

namespace {

template <typename T>
void curvature_data(const T* pos, const int64_t* rows, const bool* valid, const int32_t* offsets,
                    const int32_t* slots, T* cot, T* va, T* k_scratch, T* k_vecs, T* vertex_areas,
                    int n, int64_t nv, cudaStream_t st) {
  curvature_fwd_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(pos, rows, valid, cot, k_scratch,
                                                               va, nullptr, n, nv);
  vertex_sum::launch<T, 3, 1>(offsets, slots, k_scratch, k_vecs, va, vertex_areas, (int)nv, st);
}

template <typename T>
void curvature_data_bwd(const T* pos, const int64_t* rows, const bool* valid,
                        const int32_t* offsets, const int32_t* slots, const T* g_kvecs,
                        const T* g_varea, const T* g_cot, const T* g_va, T* dc_scratch, T* dpos,
                        int n, int64_t nv, cudaStream_t st) {
  curvature_bwd_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(
      pos, rows, valid, g_cot, nullptr, g_va, nullptr, g_kvecs, g_varea, dc_scratch, n, nv);
  vertex_sum::launch<T, 3>(offsets, slots, dc_scratch, dpos, nullptr, nullptr, (int)nv, st);
}

}  // namespace

// Cotan curvature data in one call: cot (T, 3) and va (T, 3) per corner,
// k_vecs (Nv, 3) and vertex_areas (Nv,) summed over the corner CSR
// (offsets (Nv + 1,), slots (3T,)); k_scratch is (T, 3, 3).
extern "C" int tri_curvature_data(int f64, const void* pos, const int64_t* rows,
                                  const bool* valid, const int32_t* offsets,
                                  const int32_t* slots, void* cot, void* va, void* k_scratch,
                                  void* k_vecs, void* vertex_areas, int n, int64_t nv,
                                  void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (f64) {
      curvature_data<double>((const double*)pos, rows, valid, offsets, slots, (double*)cot,
                             (double*)va, (double*)k_scratch, (double*)k_vecs,
                             (double*)vertex_areas, n, nv, st);
    } else {
      curvature_data<float>((const float*)pos, rows, valid, offsets, slots, (float*)cot,
                            (float*)va, (float*)k_scratch, (float*)k_vecs, (float*)vertex_areas,
                            n, nv, st);
    }
  }
  return (int)cudaGetLastError();
}

// Its backward in one call: dpos (Nv, 3) from the upstream of k_vecs
// (Nv, 3), vertex_areas (Nv,), cot (T, 3) and va (T, 3), any of them null;
// dc_scratch is (T, 3, 3).
extern "C" int tri_curvature_data_bwd(int f64, const void* pos, const int64_t* rows,
                                      const bool* valid, const int32_t* offsets,
                                      const int32_t* slots, const void* g_kvecs,
                                      const void* g_varea, const void* g_cot, const void* g_va,
                                      void* dc_scratch, void* dpos, int n, int64_t nv,
                                      void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (f64) {
      curvature_data_bwd<double>((const double*)pos, rows, valid, offsets, slots,
                                 (const double*)g_kvecs, (const double*)g_varea,
                                 (const double*)g_cot, (const double*)g_va, (double*)dc_scratch,
                                 (double*)dpos, n, nv, st);
    } else {
      curvature_data_bwd<float>((const float*)pos, rows, valid, offsets, slots,
                                (const float*)g_kvecs, (const float*)g_varea,
                                (const float*)g_cot, (const float*)g_va, (float*)dc_scratch,
                                (float*)dpos, n, nv, st);
    }
  }
  return (int)cudaGetLastError();
}

// div (T,), area (T,) and g (T, 3, 3) of tilt_ops.p1_triangle_divergence,
// masked as it masks them.
extern "C" int tri_p1_div(int f64, const void* pos, const void* tilts, const int64_t* rows,
                          const bool* valid, void* div, void* area, void* grads, int n,
                          int64_t nv, void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (f64) {
      p1_div_kernel<double><<<tiles_for(n), kTile, 0, st>>>(
          (const double*)pos, (const double*)tilts, rows, valid, (double*)div, (double*)area,
          (double*)grads, n, nv);
    } else {
      p1_div_kernel<float><<<tiles_for(n), kTile, 0, st>>>(
          (const float*)pos, (const float*)tilts, rows, valid, (float*)div, (float*)area,
          (float*)grads, n, nv);
    }
  }
  return (int)cudaGetLastError();
}

// The tilt gradient of <g_div, div>: dtilts (Nv, 3), row v the sum over its
// CSR slots (t, c) of [valid_t] g_div_t g[t, c], from the forward's g.
extern "C" int tri_p1_div_bwd(int f64, const int32_t* offsets, const int32_t* slots,
                              const void* grads, const bool* valid, const void* g_div,
                              void* dtilts, int64_t nv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    vertex_sum::launch_weighted<double, 3>(offsets, slots, (const double*)grads,
                                           (const double*)g_div, valid, (double*)dtilts, (int)nv,
                                           st);
  } else {
    vertex_sum::launch_weighted<float, 3>(offsets, slots, (const float*)grads,
                                          (const float*)g_div, valid, (float*)dtilts, (int)nv,
                                          st);
  }
  return (int)cudaGetLastError();
}
