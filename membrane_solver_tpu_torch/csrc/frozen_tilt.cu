// Frozen-tilt energy and its tilt gradient, one thread per triangle.
//
// Replaces the Pallas kernels of membrane_solver_tpu/pallas_kernels/frozen_tilt.py
// (_fwd_kernel and _bwd_kernel behind fused_tilt_energy).  Per triangle:
//
//   E = k_in/2  * (|t_in corners|^2 / 3)  * A_in
//     + k_out/2 * (|t_out corners|^2 / 3) * A_out
//     + kappa_in/2  * sum_c (base_in_c  - div_in )^2 * va_in_c
//     + kappa_out/2 * sum_c (base_out_c + div_out)^2 * va_out_c
//     + ks_in/4  * sum_j w_in_j  |d_j(t_in)|^2
//     + ks_out/4 * sum_j w_out_j |d_j(t_out)|^2
//
// with div = sum_c t_c . g_c (P1 divergence) and d_j the corner differences
// t1-t2, t2-t0, t0-t1.  The gradient kernel writes dE/dt_in and dE/dt_out per
// corner, scaled by the incoming gradient, which it reads from device memory
// so the caller needs no host sync.
//
// Layout: row-major (T, 3, 3) corner arrays (index corner*3 + xyz) and a
// (T, 20) payload [A_in, A_out, base_in(3), va_in(3), base_out(3), va_out(3),
// w_in(3), w_out(3)]; k = [k_in, k_out, kappa_in, kappa_out, ks_in, ks_out].
// The TPU kernel's component-major (C, T_pad) lanes and its padding to 512
// triangles are TPU tiling details and are not carried over.
//
// What bounds it on an H100: memory traffic and launch latency, not
// arithmetic (about 120 flops per triangle).  Each triangle reads 47 floats
// and writes 1 (energy) or 18 (gradient): at 21,504 triangles that is about
// 4 MB and 6 MB per call, some 2 us of HBM time at 3.35 TB/s, so a single
// call is dominated by the launch.  The design therefore stays a plain
// elementwise pass with no shared memory.  The next moves are to fuse the
// tri_rows corner gather and a deterministic scatter of the gradient to
// vertices into the kernel, to produce energy and gradient in one pass, and
// to capture the inner tilt solve's launches in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load9(const float* __restrict__ src, int t, float* dst) {
#pragma unroll
  for (int i = 0; i < 9; ++i) dst[i] = src[9 * t + i];
}

__device__ __forceinline__ float div_of(const float* t, const float* g) {
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) d += t[i] * g[i];
  return d;
}

// |d12|^2, |d20|^2, |d01|^2
__device__ __forceinline__ void dirichlet_sq(const float* t, float* sq) {
  const int a[3] = {3, 6, 0};
  const int b[3] = {6, 0, 3};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float d0 = t[a[j]] - t[b[j]];
    const float d1 = t[a[j] + 1] - t[b[j] + 1];
    const float d2 = t[a[j] + 2] - t[b[j] + 2];
    sq[j] = d0 * d0 + d1 * d1 + d2 * d2;
  }
}

// dE/dt0 = ks/2 (w2 d01 - w1 d20); dt1 = ks/2 (w0 d12 - w2 d01);
// dt2 = ks/2 (w1 d20 - w0 d12), per xyz component
__device__ __forceinline__ void dirichlet_grad(const float* t, float w0, float w1, float w2,
                                               float half_k, float* out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float d12 = t[3 + c] - t[6 + c];
    const float d20 = t[6 + c] - t[c];
    const float d01 = t[c] - t[3 + c];
    out[c] = half_k * (w2 * d01 - w1 * d20);
    out[3 + c] = half_k * (w0 * d12 - w2 * d01);
    out[6 + c] = half_k * (w1 * d20 - w0 * d12);
  }
}

__global__ void frozen_tilt_energy_kernel(const float* __restrict__ tin,
                                          const float* __restrict__ tout,
                                          const float* __restrict__ grad_p1,
                                          const float* __restrict__ pay,
                                          const float* __restrict__ kv,
                                          float* __restrict__ energy, int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float a[9], b[9], g[9], p[20];
  load9(tin, t, a);
  load9(tout, t, b);
  load9(grad_p1, t, g);
#pragma unroll
  for (int i = 0; i < 20; ++i) p[i] = pay[20 * t + i];
  const float k_in = kv[0], k_out = kv[1], kap_in = kv[2], kap_out = kv[3];
  const float ks_in = kv[4], ks_out = kv[5];

  float sq_in = 0.0f, sq_out = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    sq_in += a[i] * a[i];
    sq_out += b[i] * b[i];
  }
  float e = 0.5f * k_in * (sq_in / 3.0f) * p[0] + 0.5f * k_out * (sq_out / 3.0f) * p[1];

  const float div_in = div_of(a, g);
  const float div_out = div_of(b, g);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float term_in = p[2 + c] - div_in;
    const float term_out = p[8 + c] + div_out;
    e += 0.5f * kap_in * term_in * term_in * p[5 + c];
    e += 0.5f * kap_out * term_out * term_out * p[11 + c];
  }

  float s_in[3], s_out[3];
  dirichlet_sq(a, s_in);
  dirichlet_sq(b, s_out);
  e += 0.25f * ks_in * (p[14] * s_in[0] + p[15] * s_in[1] + p[16] * s_in[2]);
  e += 0.25f * ks_out * (p[17] * s_out[0] + p[18] * s_out[1] + p[19] * s_out[2]);
  energy[t] = e;
}

__global__ void frozen_tilt_grad_kernel(const float* __restrict__ tin,
                                        const float* __restrict__ tout,
                                        const float* __restrict__ grad_p1,
                                        const float* __restrict__ pay,
                                        const float* __restrict__ kv,
                                        const float* __restrict__ ct,
                                        float* __restrict__ din,
                                        float* __restrict__ dout, int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float a[9], b[9], g[9], p[20];
  load9(tin, t, a);
  load9(tout, t, b);
  load9(grad_p1, t, g);
#pragma unroll
  for (int i = 0; i < 20; ++i) p[i] = pay[20 * t + i];
  const float k_in = kv[0], k_out = kv[1], kap_in = kv[2], kap_out = kv[3];
  const float ks_in = kv[4], ks_out = kv[5];
  const float scale = ct[0];

  const float div_in = div_of(a, g);
  const float div_out = div_of(b, g);
  float s_in = 0.0f, s_out = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s_in += (p[2 + c] - div_in) * p[5 + c];
    s_out += (p[8 + c] + div_out) * p[11 + c];
  }
  const float m_in = k_in * p[0] / 3.0f;
  const float m_out = k_out * p[1] / 3.0f;
  const float coef_in = kap_in * s_in;
  const float coef_out = kap_out * s_out;

  float sm_in[9], sm_out[9];
  dirichlet_grad(a, p[14], p[15], p[16], 0.5f * ks_in, sm_in);
  dirichlet_grad(b, p[17], p[18], p[19], 0.5f * ks_out, sm_out);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    din[9 * t + i] = scale * (m_in * a[i] - coef_in * g[i] + sm_in[i]);
    dout[9 * t + i] = scale * (m_out * b[i] + coef_out * g[i] + sm_out[i]);
  }
}

inline unsigned int blocks_for(int T) { return (unsigned int)((T + kThreads - 1) / kThreads); }

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
extern "C" int frozen_tilt_energy(const float* tin, const float* tout, const float* grad_p1,
                                  const float* pay, const float* kv, float* energy, int T,
                                  void* stream) {
  if (T > 0) {
    frozen_tilt_energy_kernel<<<blocks_for(T), kThreads, 0, (cudaStream_t)stream>>>(
        tin, tout, grad_p1, pay, kv, energy, T);
  }
  return (int)cudaGetLastError();
}

extern "C" int frozen_tilt_grad(const float* tin, const float* tout, const float* grad_p1,
                                const float* pay, const float* kv, const float* ct, float* din,
                                float* dout, int T, void* stream) {
  if (T > 0) {
    frozen_tilt_grad_kernel<<<blocks_for(T), kThreads, 0, (cudaStream_t)stream>>>(
        tin, tout, grad_p1, pay, kv, ct, din, dout, T);
  }
  return (int)cudaGetLastError();
}
