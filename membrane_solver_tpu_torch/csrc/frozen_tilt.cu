// Frozen-tilt energy and its vertex tilt gradient in one call: the corner
// gather, the energy sum and the scatter to vertices are in the kernels.
//
// Replaces the Pallas kernels of membrane_solver_tpu/pallas_kernels/frozen_tilt.py
// (_fwd_kernel :83 and _bwd_kernel :111, behind fused_tilt_energy and the
// pallas_call at :186), together with what surrounded them in each call of
// the relax: the two tri_rows corner gathers, the sum of per-triangle
// energies, and the scatter of corner gradients to vertices.  Per triangle:
//
//   E = k_in/2  * (|t_in corners|^2 / 3)  * A_in
//     + k_out/2 * (|t_out corners|^2 / 3) * A_out
//     + kappa_in/2  * sum_c (base_in_c  - div_in )^2 * va_in_c
//     + kappa_out/2 * sum_c (base_out_c + div_out)^2 * va_out_c
//     + ks_in/4  * sum_j w_in_j  |d_j(t_in)|^2
//     + ks_out/4 * sum_j w_out_j |d_j(t_out)|^2
//
// with div = sum_c t_c . g_c (P1 divergence) and d_j the corner differences
// t1-t2, t2-t0, t0-t1.
//
// Layout: (N, 3) vertex tilts, (T, 3) int64 tri_rows, row-major (T, 3, 3)
// P1 gradients g (index corner*3 + xyz), a (T, 20) payload [A_in, A_out,
// base_in(3), va_in(3), base_out(3), va_out(3), w_in(3), w_out(3)] and
// k = [k_in, k_out, kappa_in, kappa_out, ks_in, ks_out].
//
// One C call, frozen_tilt_vertex, runs:
//  1. frozen_tilt_kernel, one thread per triangle, 128 per block.  Thread 0
//     starts two 1-D bulk copies (TMA, cp.async.bulk completing on an
//     mbarrier) of the block's contiguous payload and g slabs into shared
//     memory; meanwhile every thread gathers its three corner tilts of both
//     leaflets through tri_rows.  The energy is summed in the kernel: warp
//     shuffles, then the block's warps, then one partial per block; the last
//     block to finish (a device counter that it resets itself) adds the
//     partials in block order and writes the scalar (block_sum.cuh).  Every
//     sum runs in a fixed order, in double, so the result is the same bits
//     on every run.
//     With the gradient, each thread also puts its corners' dE/dt_in and
//     dE/dt_out into shared memory, and the block writes them to a
//     (T, 3, 3) scratch per leaflet, which stays in L2, as coalesced 16-byte
//     stores of its contiguous slab.
//  2. with the gradient only: the vertex-sum kernel (vertex_sum.cuh) adds
//     the scratch rows into the (N, 3) vertex gradients in the order of the
//     topology's corner CSR: no atomics, deterministic.
// The caller owns the scratch, partials and counter (allocated once per
// relax; the counter zeroed once) and the outputs.
//
// The member axis (the batched line search's candidates and the member-
// batched leaflet relax, runtime/tilt_relax.py): frozen_tilt_members runs
// the kernel over B stacked tilt pairs, one block row per member on the
// grid's y axis (gridDim.y = B).  The kernel offsets its per-member pointers
// (tilts, corner scratch, partials, counter, energy) by blockIdx.y, and g
// and the payload by blockIdx.y times their member strides: a stride of 0
// shares them (the candidates of one relax), a stride of one member's slab
// gives each member its own frozen inputs (the relaxes of several trial
// surfaces).  tri_rows, the corner CSR and k are shared.  With the
// gradient, the member vertex sum adds each member's scratch in the CSR's
// order.  A member's arithmetic and its energy and vertex reductions run in
// the order of a call on that member alone (gridDim.y = 1, every offset
// zero), so member m of a B-member call is the single call's bits.  A
// member's g slab or corner scratch that does not start on a 16-byte
// boundary (a member stride of 9T floats with T not a multiple of 4) is read
// with plain loads in place of the bulk copy, and written with 4-byte
// stores: the same values, another path.
// What bounds it on an H100: bytes, then latency.  At the kozlov L3 lane
// (N = 10,817, T = 21,504) the energy reads 3.27 MB (vertex tilts, int64
// tri_rows, g, payload), about 1 us at 3.35 TB/s, and the gradient adds
// 0.26 MB of vertex gradients (3.53 MB, 1.05 us); this design also reads
// the 0.30 MB corner CSR and passes 1.5 MB of scratch through L2.  About
// 190 flops per triangle for the energy and 270 more for the gradient, far
// below the float32 peak, and no matrix product, so no tensor cores.  128
// threads per block give 168 blocks at L3, enough to put work on every one
// of the 132 SMs; the bulk copies make the payload and g reads whole-slab
// transfers that overlap the dependent tri_rows -> tilt gathers (on the
// card they beat 16-byte cp.async and plain 16-byte loads of the same
// slabs; PERF.md).  The 80-byte payload rows keep every slab 16-byte
// aligned; the g slab's last bytes past a 16-byte multiple (under 16) are
// plain loads.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_sum.cuh"
#include "vertex_sum.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPay = 20;  // payload floats per triangle

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One 1-D TMA copy of ``bytes`` (a multiple of 16; both ends 16-byte aligned)
// from global to shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
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

// ``n`` floats from shared ``src`` (16-byte aligned) to global ``dst`` by the
// whole block: coalesced 16-byte stores where ``dst`` is 16-byte aligned
// (always for a single call), else 4-byte stores (a member's slab of a
// member stride of 9T floats with T not a multiple of 4).
__device__ __forceinline__ void store_slab(float* __restrict__ dst, const float* src, int n) {
  const int n4 = (reinterpret_cast<uintptr_t>(dst) & 15u) == 0 ? n >> 2 : 0;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
    frozen_tilt_kernel(const float* __restrict__ tin, const float* __restrict__ tout,
                       const int64_t* __restrict__ rows, const float* __restrict__ grad_p1,
                       const float* __restrict__ pay, const float* __restrict__ kv,
                       float* __restrict__ din_c, float* __restrict__ dout_c,
                       double* __restrict__ partials, unsigned int* __restrict__ counter,
                       float* __restrict__ energy, int n, int64_t nv, int64_t g_stride,
                       int64_t pay_stride) {
  __shared__ alignas(128) float s_pay[kThreads * kPay];
  __shared__ alignas(128) float s_g[kThreads * 9];
  __shared__ alignas(8) uint64_t s_bar;

  // member blockIdx.y: its tilts, corner scratch, partials, counter and
  // energy, and g and the payload at their member strides (0: shared); the
  // rows and k are shared
  const int64_t member = blockIdx.y;
  tin += member * nv * 3;
  tout += member * nv * 3;
  grad_p1 += member * g_stride;
  pay += member * pay_stride;
  if constexpr (kGrad) {
    din_c += member * 9 * (int64_t)n;
    dout_c += member * 9 * (int64_t)n;
  }
  partials += member * gridDim.x;
  counter += member;
  energy += member;

  const int tid = threadIdx.x;
  const int first = blockIdx.x * kThreads;
  const int here = min(kThreads, n - first);
  const float* pay_slab = pay + (int64_t)first * kPay;  // 80-byte rows: 16-byte aligned
  const float* g_slab = grad_p1 + (int64_t)first * 9;   // 128 * 36 bytes per block
  // aligned when the member's g is (always for a single call)
  const bool g_aligned = (reinterpret_cast<uintptr_t>(g_slab) & 15u) == 0;

  // 1. thread 0 starts the block's slab copies
  const uint32_t pay_bytes = (uint32_t)here * (kPay * 4u);
  const uint32_t g_bulk = g_aligned ? ((uint32_t)here * 36u) & ~15u : 0u;
  if (tid == 0) mbar_init(&s_bar, 1);
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&s_bar, pay_bytes + g_bulk);
    bulk_copy_g2s(s_pay, pay_slab, pay_bytes, &s_bar);
    if (g_bulk > 0) bulk_copy_g2s(s_g, g_slab, g_bulk, &s_bar);
  }
  // the g slab's last floats past a 16-byte multiple (fewer than 4), or the
  // whole slab when it is not aligned
  for (int i = (int)(g_bulk >> 2) + tid; i < here * 9; i += kThreads) s_g[i] = g_slab[i];

  // 2. meanwhile each thread gathers its corners (a bad row gives NaN)
  const int t = first + tid;
  const bool live = t < n;
  bool ok = live;
  float a[9], b[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int64_t r = live ? rows[3 * (int64_t)t + k] : 0;
    if (r < 0 || r >= nv) {
      ok = false;
      r = 0;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[3 * k + c] = ok ? tin[3 * r + c] : 0.0f;
      b[3 * k + c] = ok ? tout[3 * r + c] : 0.0f;
    }
  }

  mbar_wait(&s_bar, 0);
  __syncthreads();  // the g tail written by other threads

  double e_thread = 0.0;
  float o_in[9], o_out[9];  // the corner gradients
  if (live) {
    float p[kPay], g[9];
    const float4* p4 = reinterpret_cast<const float4*>(s_pay + tid * kPay);
#pragma unroll
    for (int j = 0; j < kPay / 4; ++j) {
      const float4 q = p4[j];
      p[4 * j] = q.x;
      p[4 * j + 1] = q.y;
      p[4 * j + 2] = q.z;
      p[4 * j + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) g[i] = s_g[tid * 9 + i];
    const float k_in = kv[0], k_out = kv[1], kap_in = kv[2], kap_out = kv[3];
    const float ks_in = kv[4], ks_out = kv[5];
    const float qnan = __int_as_float(0x7fc00000);

    float sq_in = 0.0f, sq_out = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      sq_in += a[i] * a[i];
      sq_out += b[i] * b[i];
    }
    float e = 0.5f * k_in * (sq_in / 3.0f) * p[0] + 0.5f * k_out * (sq_out / 3.0f) * p[1];
    const float div_in = div_of(a, g);
    const float div_out = div_of(b, g);
    float s_in = 0.0f, s_out = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float term_in = p[2 + c] - div_in;
      const float term_out = p[8 + c] + div_out;
      e += 0.5f * kap_in * term_in * term_in * p[5 + c];
      e += 0.5f * kap_out * term_out * term_out * p[11 + c];
      s_in += term_in * p[5 + c];
      s_out += term_out * p[11 + c];
    }
    float d_in[3], d_out[3];
    dirichlet_sq(a, d_in);
    dirichlet_sq(b, d_out);
    e += 0.25f * ks_in * (p[14] * d_in[0] + p[15] * d_in[1] + p[16] * d_in[2]);
    e += 0.25f * ks_out * (p[17] * d_out[0] + p[18] * d_out[1] + p[19] * d_out[2]);
    e_thread = ok ? (double)e : (double)qnan;

    if constexpr (kGrad) {
      const float m_in = k_in * p[0] / 3.0f;
      const float m_out = k_out * p[1] / 3.0f;
      const float coef_in = kap_in * s_in;
      const float coef_out = kap_out * s_out;
      float sm_in[9], sm_out[9];
      dirichlet_grad(a, p[14], p[15], p[16], 0.5f * ks_in, sm_in);
      dirichlet_grad(b, p[17], p[18], p[19], 0.5f * ks_out, sm_out);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        o_in[i] = ok ? m_in * a[i] - coef_in * g[i] + sm_in[i] : qnan;
        o_out[i] = ok ? m_out * b[i] + coef_out * g[i] + sm_out[i] : qnan;
      }
    }
  }

  // 3. the corner gradients to the scratch, through the payload slab (free
  // once every thread is past the barrier below), as coalesced 16-byte stores
  if constexpr (kGrad) {
    float* s_in = s_pay;
    float* s_out = s_pay + kThreads * 9;
    __syncthreads();
    if (live) {
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        s_in[tid * 9 + i] = o_in[i];
        s_out[tid * 9 + i] = o_out[i];
      }
    }
    __syncthreads();
    store_slab(din_c + (int64_t)first * 9, s_in, here * 9);
    store_slab(dout_c + (int64_t)first * 9, s_out, here * 9);
  }

  // 4. the energy: block partials, added in block order by the last block
  double total;
  if (block_sum::grid_sum<kThreads>(e_thread, partials, counter, &total)) energy[0] = (float)total;
}

}  // namespace

// Plain C entry point (bound with ctypes).  ``grad`` 0: the energy alone
// (one launch); 1: the energy and the (N, 3) vertex gradients (two launches,
// din_c / dout_c being (T, 3, 3) scratch).  partials holds one double per
// block of 128 triangles, counter one zeroed uint32.  Launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for n < 1).
extern "C" int frozen_tilt_vertex(const float* tin, const float* tout, const int64_t* rows,
                                  const int32_t* offsets, const int32_t* slots,
                                  const float* grad_p1, const float* pay, const float* kv,
                                  float* din_c, float* dout_c, double* partials,
                                  unsigned int* counter, float* energy, float* gin, float* gout,
                                  int n, int nv, int grad, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  if (grad) {
    frozen_tilt_kernel<true><<<blocks, kThreads, 0, st>>>(tin, tout, rows, grad_p1, pay, kv,
                                                          din_c, dout_c, partials, counter,
                                                          energy, n, nv, 0, 0);
    vertex_sum::launch<float, 3, 3>(offsets, slots, din_c, gin, dout_c, gout, nv, st);
  } else {
    frozen_tilt_kernel<false><<<blocks, kThreads, 0, st>>>(tin, tout, rows, grad_p1, pay, kv,
                                                           nullptr, nullptr, partials, counter,
                                                           energy, n, nv, 0, 0);
  }
  return (int)cudaGetLastError();
}

// frozen_tilt_vertex over ``members`` stacked tilt pairs in one launch (two
// with the gradient): tin and tout (members, nv, 3); g and the payload at
// ``g_stride`` and ``pay_stride`` floats per member (0: shared); partials
// (members, blocks of 128 triangles), counter (members,) zeroed (left at
// zero), energy (members,); with ``grad``, din_c / dout_c (members, T, 3, 3)
// scratch and gin / gout (members, nv, 3).  rows, the CSR and kv are shared.
// Member m is the bits of frozen_tilt_vertex on member m alone.
// cudaErrorInvalidValue for n < 1 or members < 1.
extern "C" int frozen_tilt_members(const float* tin, const float* tout, const int64_t* rows,
                                   const int32_t* offsets, const int32_t* slots,
                                   const float* grad_p1, const float* pay, const float* kv,
                                   float* din_c, float* dout_c, double* partials,
                                   unsigned int* counter, float* energy, float* gin, float* gout,
                                   int n, int nv, int members, int64_t g_stride,
                                   int64_t pay_stride, int grad, void* stream) {
  if (n < 1 || members < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned int)((n + kThreads - 1) / kThreads), (unsigned int)members);
  if (grad) {
    frozen_tilt_kernel<true><<<grid, kThreads, 0, st>>>(tin, tout, rows, grad_p1, pay, kv, din_c,
                                                        dout_c, partials, counter, energy, n, nv,
                                                        g_stride, pay_stride);
    vertex_sum::launch<float, 3, 3>(offsets, slots, din_c, gin, dout_c, gout, nv, st, members,
                                    3 * (int64_t)n);
  } else {
    frozen_tilt_kernel<false><<<grid, kThreads, 0, st>>>(tin, tout, rows, grad_p1, pay, kv,
                                                         nullptr, nullptr, partials, counter,
                                                         energy, n, nv, g_stride, pay_stride);
  }
  return (int)cudaGetLastError();
}

// Triangles per block, for the caller's partials buffer.
extern "C" int frozen_tilt_block_size() { return kThreads; }
