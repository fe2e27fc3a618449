// Per-triangle geometry kernels, one thread per triangle, float and double.
//
// Replace the Pallas kernels of membrane_solver_tpu/pallas_kernels/tri_kernels.py:
//
//   tri_surface_fwd     <- _surface_kernel   (surface_corner_grads_pallas)
//   tri_curvature_fwd   <- _curvature_kernel (curvature_corners_pallas)
//   tri_curvature_bwd      (its backward; the Pallas kernel had none: JAX
//                           differentiates the stock geo.curvature_data)
//   tri_p1_div_fwd      <- _p1_div_kernel    (p1_divergence_pallas)
//
// Each thread reads its three corners straight from the (Nv, 3) positions
// (and tilts) through the (T, 3) int64 tri_rows, so the corner gather is in
// the kernel; it writes row-major per-triangle outputs in the layout of the
// JAX functions (corner vectors as (T, 3, 3), index corner * 3 + xyz).  The
// scatter back to vertices stays an index_add in the wrapper, as the JAX
// kernels leave it to their caller.  A row index outside [0, Nv) makes that
// triangle's outputs NaN instead of reading out of bounds.
//
// The arithmetic follows the plain twins in device/geo.py and
// device/tilt_ops.py operation by operation; the file is built with
// -fmad=false so that no multiply-add is contracted, which keeps the Meyer
// obtuse-branch tests (c < 0) on the same side as the twin's where the
// cotangent sits at a tie (the right triangles of a refined cube).
//
// What bounds it on an H100: memory traffic and launch latency.  Per
// triangle the curvature forward reads 3 int64 rows + 9 coordinates and
// writes 16 values (~230 bytes at float64); at 24,576 triangles that is
// ~6 MB, about 2 us of HBM time at 3.35 TB/s, against several us of launch
// overhead, so the design stays a plain elementwise pass: no shared memory,
// no padding (the ragged edge is a bounds check), registers only.  The
// backward recomputes the forward in registers rather than reading saved
// intermediates, which trades ~100 flops for ~200 bytes per triangle.  The
// next moves are a fused scatter to vertices and fusing the surface and
// curvature passes, which read the same corners.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
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
// surface: e = gamma * A, corner gradients dE/dv_k = gamma/2 * n_hat x (v_{k+2} - v_{k+1})
// ---------------------------------------------------------------------
template <typename T>
__global__ void surface_fwd_kernel(const T* __restrict__ pos, const int64_t* __restrict__ rows,
                                   const T* __restrict__ gamma, T* __restrict__ energy,
                                   T* __restrict__ grads, int n, int64_t nv) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  V3<T> v[3];
  if (!load_corners(pos, rows, t, nv, v)) {
    const T q = nan_of<T>();
    energy[t] = q;
    for (int i = 0; i < 9; ++i) grads[9 * t + i] = q;
    return;
  }
  const T eps = T(kEpsArea);
  const V3<T> nrm = cross(sub(v[1], v[0]), sub(v[2], v[0]));
  const T dbl = sqrt(dot(nrm, nrm));
  const bool ok = dbl >= eps;
  const T den = dbl > eps ? dbl : eps;
  const V3<T> n_hat = ok ? V3<T>{nrm.x / den, nrm.y / den, nrm.z / den} : V3<T>{T(0), T(0), T(0)};
  const T g = gamma[t];
  const T area = ok ? T(0.5) * dbl : T(0);
  const T half_g = T(0.5) * g;
  energy[t] = g * area;
  store(grads, 3 * t + 0, scale(half_g, cross(n_hat, sub(v[2], v[1]))));
  store(grads, 3 * t + 1, scale(half_g, cross(n_hat, sub(v[0], v[2]))));
  store(grads, 3 * t + 2, scale(half_g, cross(n_hat, sub(v[1], v[0]))));
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
    tri_area[t] = q;
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
  tri_area[t] = area;
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

template <typename T>
__global__ void curvature_bwd_kernel(const T* __restrict__ pos, const int64_t* __restrict__ rows,
                                     const bool* __restrict__ valid, const T* __restrict__ g_cot,
                                     const T* __restrict__ g_kv, const T* __restrict__ g_va,
                                     const T* __restrict__ g_area, T* __restrict__ dp, int n,
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
  const V3<T> gk0 = {g_kv[9 * t + 0], g_kv[9 * t + 1], g_kv[9 * t + 2]};
  const V3<T> gk1 = {g_kv[9 * t + 3], g_kv[9 * t + 4], g_kv[9 * t + 5]};
  const V3<T> gk2 = {g_kv[9 * t + 6], g_kv[9 * t + 7], g_kv[9 * t + 8]};

  // adjoints of the cotangents, the squared lengths, the area and the edges
  T gc0 = g_cot[3 * t + 0] * m;
  T gc1 = g_cot[3 * t + 1] * m;
  T gc2 = g_cot[3 * t + 2] * m;
  T gl0 = T(0), gl1 = T(0), gl2 = T(0);
  T gA = g_area[t];
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
  va_adjoint(g_va[3 * t + 0] * m, s.obt0, s.obt1 || s.obt2, any_obt, s.l1, s.c1, s.l2, s.c2, gA,
             gl1, gc1, gl2, gc2);
  va_adjoint(g_va[3 * t + 1] * m, s.obt1, s.obt0 || s.obt2, any_obt, s.l2, s.c2, s.l0, s.c0, gA,
             gl2, gc2, gl0, gc0);
  va_adjoint(g_va[3 * t + 2] * m, s.obt2, s.obt0 || s.obt1, any_obt, s.l0, s.c0, s.l1, s.c1, gA,
             gl0, gc0, gl1, gc1);

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
__global__ void p1_div_fwd_kernel(const T* __restrict__ pos, const T* __restrict__ tilts,
                                  const int64_t* __restrict__ rows, T* __restrict__ div,
                                  T* __restrict__ area, T* __restrict__ grads, int n, int64_t nv) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  V3<T> v[3], tc[3];
  const bool ok_v = load_corners(pos, rows, t, nv, v);
  const bool ok_t = load_corners(tilts, rows, t, nv, tc);
  if (!(ok_v && ok_t)) {
    const T q = nan_of<T>();
    div[t] = area[t] = q;
    for (int i = 0; i < 9; ++i) grads[9 * t + i] = q;
    return;
  }
  const T eps = T(kEpsArea);
  const V3<T> e[3] = {sub(v[2], v[1]), sub(v[0], v[2]), sub(v[1], v[0])};
  const V3<T> nrm = cross(e[1], e[2]);
  const T sq = dot(nrm, nrm);
  const T n_sq = sq > eps * eps ? sq : eps * eps;
  T d = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const V3<T> c = cross(nrm, e[k]);
    const V3<T> g = {c.x / n_sq, c.y / n_sq, c.z / n_sq};
    store(grads, 3 * t + k, g);
    d = d + dot(tc[k], g);
  }
  div[t] = d;
  area[t] = T(0.5) * sqrt(sq > T(0) ? sq : T(0));
}

inline unsigned int blocks_for(int n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

// Plain C entry points (bound with ctypes).  ``f64`` selects double (1) or
// float (0) for every floating-point pointer.  Each launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
extern "C" int tri_surface_fwd(int f64, const void* pos, const int64_t* rows, const void* gamma,
                               void* energy, void* grads, int n, int64_t nv, void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (f64) {
      surface_fwd_kernel<double><<<blocks_for(n), kThreads, 0, st>>>(
          (const double*)pos, rows, (const double*)gamma, (double*)energy, (double*)grads, n, nv);
    } else {
      surface_fwd_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
          (const float*)pos, rows, (const float*)gamma, (float*)energy, (float*)grads, n, nv);
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
          (const double*)g_va, (const double*)g_area, (double*)dp, n, nv);
    } else {
      curvature_bwd_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
          (const float*)pos, rows, valid, (const float*)g_cot, (const float*)g_kv,
          (const float*)g_va, (const float*)g_area, (float*)dp, n, nv);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int tri_p1_div_fwd(int f64, const void* pos, const void* tilts, const int64_t* rows,
                              void* div, void* area, void* grads, int n, int64_t nv,
                              void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (f64) {
      p1_div_fwd_kernel<double><<<blocks_for(n), kThreads, 0, st>>>(
          (const double*)pos, (const double*)tilts, rows, (double*)div, (double*)area,
          (double*)grads, n, nv);
    } else {
      p1_div_fwd_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
          (const float*)pos, (const float*)tilts, rows, (float*)div, (float*)area,
          (float*)grads, n, nv);
    }
  }
  return (int)cudaGetLastError();
}
