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
//  1. frozen_tilt_kernel, one thread per triangle, 128 per block (a tile).
//     Thread 0 starts two 1-D bulk copies (TMA, cp.async.bulk completing on
//     an mbarrier) of the tile's contiguous payload and g slabs into shared
//     memory; meanwhile every thread gathers its three corner tilts of both
//     leaflets through tri_rows.  The energy is summed in the kernel: warp
//     shuffles, then the block's warps, then one partial per block; the last
//     block to finish (a device counter that it resets itself) adds the
//     partials in block order and writes the scalar (block_sum.cuh).  Every sum runs in a fixed order, in
//     double, so the result is the same bits on every run.  The per-triangle
//     arithmetic is one function, triangle_energy, for every launch form.
//     With the gradient, each thread writes its corners' dE/dt_in and
//     dE/dt_out as one 6-float row a corner to a (T, 3, 6) scratch.
//  2. with the gradient only: the vertex-sum kernel (vertex_sum.cuh, paired
//     6-float rows) adds the scratch rows into the (N, 3) vertex gradients
//     in the order of the topology's corner CSR, ((0 + c_0) + c_1) + ...: no
//     atomics, deterministic.
// The caller owns the scratch, partials and counter (allocated once per
// relax; the counter zeroed once) and the outputs.
//
// The member axis (the batched line search's candidates and the member-
// batched leaflet relax, runtime/tilt_relax.py): frozen_tilt_members runs
// the same kernel over B stacked tilt pairs.  Block (x, y) takes tile x for
// a group of kM members y * kM ... (the last group may hold fewer).  With g
// and the payload shared (the candidates of one relax) a block copies the
// slabs, reads the rows and each thread its payload row once for the group,
// and keeps the group's 18 kM tilt gathers in flight together; each
// member's energy takes the same block tree into its own partial, and the
// group's last block adds each member's partials in block order
// (block_sum::grid_sums).  With per-member g and payload (the relaxes of
// several trial surfaces) a block takes one member and that member's slabs.
// With the gradient, each thread also puts its corners' rows into a corner
// slab in shared memory; a vertex whose corners all lie in the tile
// (interior: 8,344 of kozlov L3's 10,817 vertices) is summed by the block
// from the slab in the corner CSR's slot order, and its rows written; only
// the corners of the other (boundary) vertices go to the scratch (14,784 of
// 64,512 at L3), and the vertex sum skips interior rows.  The same adds in
// the same order as the single call's vertex sum, so the same bits.  The
// tables (each tile's interior vertices, a corner mask per triangle) are
// made once per topology (kernels/vertex_sum.tile_sums).
// The wrapper groups shared inputs by up to 4 once B is above 4 (B = 11:
// 4, 4, 3), one member a block otherwise: measured at B = 3, 9 and 11,
// larger groups cost occupancy and one member a block fills more of the card
// at small B (PERF.md).  A member's arithmetic and its energy and vertex
// sums run in the order of a call on that member alone, so member m of a
// B-member call is the single call's bits at any group.  A member's g slab
// that does not start on a 16-byte boundary (a member stride of 9T floats
// with T not a multiple of 4) is read with plain loads in place of the bulk
// copy: the same values, another path.
// What bounds it on an H100: latency, not bytes.  At the kozlov L3 lane
// (N = 10,817, T = 21,504) the energy must read 3.27 MB (vertex tilts, int64
// tri_rows, g, payload), about 1 us at 3.35 TB/s, and the gradient adds
// 0.26 MB of vertex gradients (plus the 0.30 MB corner CSR the vertex sum
// reads).  About 190 flops per triangle for the energy and 270 more for the
// gradient, far below the float32 peak, and no matrix product, so no tensor
// cores.  A launch is one or two waves of short blocks, each a chain of
// dependent steps: slab copy and tri_rows -> tilt gathers, the arithmetic,
// then the block tree, the arrival on the counter and, in the last block,
// the partials; cutting the sums out of the kernel on the card took 40-45%
// off the shared energy launches and the single one (PERF.md).  A member
// gradient's cost was the corner scratch written and read back, which the
// in-tile sums cut to a quarter.  The 80-byte payload rows keep every slab
// 16-byte aligned; the g slab's last bytes past a 16-byte multiple (under
// 16) are plain loads.

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

// Floats of one block's slabs: a payload slab, a g slab, and a slab of corner
// gradients (kCorner floats a corner: dE/dt_in xyz, then dE/dt_out xyz).
constexpr int kCorner = 6;
constexpr int kPaySlab = kThreads * kPay;
constexpr int kGSlab = kThreads * 9;
constexpr int kCornerSlab = kThreads * 3 * kCorner;

// One triangle's energy from its corner tilts a (inner leaflet) and b
// (outer), its payload row p, P1 gradients g and k; with kGrad also its
// corner gradients dE/da and dE/db (NaN where ``ok`` is false).  The single
// call and every member run this one arithmetic.
template <bool kGrad>
__device__ __forceinline__ float triangle_energy(const float (&a)[9], const float (&b)[9],
                                                 const float (&p)[kPay], const float (&g)[9],
                                                 const float (&k)[6], bool ok, float (&o_in)[9],
                                                 float (&o_out)[9]) {
  const float k_in = k[0], k_out = k[1], kap_in = k[2], kap_out = k[3];
  const float ks_in = k[4], ks_out = k[5];
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
  return e;
}

// A thread's payload row and P1 gradients from the block's slabs in shared
// memory.
__device__ __forceinline__ void load_row(const float* s_pay, const float* s_g, float (&p)[kPay],
                                         float (&g)[9]) {
  const float4* p4 = reinterpret_cast<const float4*>(s_pay + threadIdx.x * kPay);
#pragma unroll
  for (int j = 0; j < kPay / 4; ++j) {
    const float4 q = p4[j];
    p[4 * j] = q.x;
    p[4 * j + 1] = q.y;
    p[4 * j + 2] = q.z;
    p[4 * j + 3] = q.w;
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) g[i] = s_g[threadIdx.x * 9 + i];
}

// ``count`` floats (even) from shared ``src`` (16-byte aligned) to global
// ``dst`` by the whole block: coalesced 16-byte stores where ``dst`` is 16-byte
// aligned and ``count`` a multiple of 4 (a single call's tiles but the last
// odd one), else 8-byte stores.
__device__ __forceinline__ void store_slab(float* __restrict__ dst, const float* src, int count) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0 && count % 4 == 0) {
    for (int i = threadIdx.x; i < count / 4; i += kThreads) {
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    }
  } else {
    for (int i = threadIdx.x; i < count / 2; i += kThreads) {
      reinterpret_cast<float2*>(dst)[i] = reinterpret_cast<const float2*>(src)[i];
    }
  }
}

// Bytes of the g slab at ``g_slab`` (``here`` triangles) that go by bulk
// copy: the largest multiple of 16 when it starts on a 16-byte boundary,
// else none (plain loads).
__device__ __forceinline__ uint32_t g_bulk_bytes(const float* g_slab, int here) {
  const bool aligned = (reinterpret_cast<uintptr_t>(g_slab) & 15u) == 0;
  return aligned ? ((uint32_t)here * 36u) & ~15u : 0u;
}

// Block (x, y): the 128-triangle tile x for the group of members y * kM ..
// y * kM + kM - 1 (the last group may hold fewer; ``members`` in all).  A
// group of more than one member shares g and the payload (both strides 0),
// so every block copies one payload slab and one g slab, and a thread reads
// its payload row and P1 gradients once for its group.  kShared: both
// strides are 0 (a single call, or a relax's candidates): such a launch is a
// wave or two of latency-bound blocks, so with the gradient a thread reads
// its tile's interior vertex rows ahead; with per-member inputs (kM = 1, the
// member relax) those registers go to occupancy.  Dynamic shared memory: the
// payload slab, the g slab and, with the gradient, the corner slab.
template <bool kGrad, int kM, bool kShared>
__global__ void __launch_bounds__(kThreads)
    frozen_tilt_kernel(const float* __restrict__ tin, const float* __restrict__ tout,
                       const int64_t* __restrict__ rows, const float* __restrict__ grad_p1,
                       const float* __restrict__ pay, const float* __restrict__ kv,
                       const int32_t* __restrict__ offsets, const int32_t* __restrict__ slots,
                       const int32_t* __restrict__ tile_vertices,
                       const int32_t* __restrict__ tile_offsets,
                       const uint8_t* __restrict__ corner_mask, float* __restrict__ corners,
                       float* __restrict__ gin, float* __restrict__ gout,
                       double* __restrict__ partials, unsigned int* __restrict__ counter,
                       float* __restrict__ energy, int n, int64_t nv, int members,
                       int64_t g_stride, int64_t pay_stride) {
  static_assert(kShared || kM == 1, "a group of members shares g and the payload");
  extern __shared__ __align__(128) float s_dyn[];
  __shared__ alignas(8) uint64_t s_bar;
  float* s_pay = s_dyn;
  float* s_g = s_pay + kPaySlab;
  float* s_corner = s_g + kGSlab;

  // the group's first member: its tilts, g, payload, corner scratch, vertex
  // gradients, partials and energy; the group's counter; the rows, the CSR,
  // the tile tables and k are shared
  const int64_t first_member = (int64_t)blockIdx.y * kM;
  const int here_m = members - first_member < kM ? (int)(members - first_member) : kM;
  tin += first_member * nv * 3;
  tout += first_member * nv * 3;
  if constexpr (kGrad) {
    corners += first_member * 3 * (int64_t)n * kCorner;
    gin += first_member * nv * 3;
    gout += first_member * nv * 3;
  }
  partials += first_member * gridDim.x;
  counter += blockIdx.y;
  energy += first_member;

  const int tid = threadIdx.x;
  const int first = blockIdx.x * kThreads;
  const int here = min(kThreads, n - first);
  const float* pay_slab = pay + first_member * pay_stride + (int64_t)first * kPay;
  const float* g_slab = grad_p1 + first_member * g_stride + (int64_t)first * 9;
  const uint32_t pay_bytes = (uint32_t)here * (kPay * 4u);  // 80-byte rows: 16-byte aligned
  const uint32_t g_bulk = g_bulk_bytes(g_slab, here);

  // 1. thread 0 starts the two slab copies
  if (tid == 0) mbar_init(&s_bar, 1);
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&s_bar, pay_bytes + g_bulk);
    bulk_copy_g2s(s_pay, pay_slab, pay_bytes, &s_bar);
    if (g_bulk > 0) bulk_copy_g2s(s_g, g_slab, g_bulk, &s_bar);
  }
  // the g slab's last floats past a 16-byte multiple (fewer than 4), or the
  // whole slab when it is not aligned (a member stride of 9T floats, T not a
  // multiple of 4)
  for (int i = (int)(g_bulk >> 2) + tid; i < here * 9; i += kThreads) s_g[i] = g_slab[i];

  // 2. meanwhile each thread reads its triangle's rows once and gathers every
  // member's corners: the group's 18 kM loads in flight together (a bad row
  // gives NaN)
  const int t = first + tid;
  const bool live = t < n;
  bool ok = live;
  int64_t r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r[c] = live ? rows[3 * (int64_t)t + c] : 0;
    if (r[c] < 0 || r[c] >= nv) {
      ok = false;
      r[c] = 0;
    }
  }
  float a[kM][9], b[kM][9];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const bool load = ok && m < here_m;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        a[m][3 * c + x] = load ? tin[m * nv * 3 + 3 * r[c] + x] : 0.0f;
        b[m][3 * c + x] = load ? tout[m * nv * 3 + 3 * r[c] + x] : 0.0f;
      }
    }
  }
  float k[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) k[i] = kv[i];
  // with the gradient, the tile's interior vertices and the corners to send;
  // with shared inputs also this thread's first interior vertex and its
  // corners, read while the slabs land (the same for every member)
  int interior_lo = 0, interior_hi = 0, iv = -1, i_lo = 0, i_hi = 0;
  int i_ahead[vertex_sum::kAhead];
  unsigned int mask = 0;
  if constexpr (kGrad) {
    // no tables (a single call): every corner through the scratch
    if (tile_offsets != nullptr) {
      interior_lo = tile_offsets[blockIdx.x];
      interior_hi = tile_offsets[blockIdx.x + 1];
    }
    mask = live && corner_mask != nullptr ? corner_mask[t] : 0u;
    if (kShared && interior_lo + tid < interior_hi) {
      iv = tile_vertices[interior_lo + tid];
      vertex_sum::read_interior(iv, offsets, slots, 3 * first, i_lo, i_hi, i_ahead);
    }
  }

  mbar_wait(&s_bar, 0);
  __syncthreads();  // the g tails written by other threads

  // 3. each member's energy and, with the gradient, its corner gradients into
  // the block's corner slab: the tile's interior vertices are summed from it
  // in the corner CSR's order and written here; the corners of boundary
  // vertices go to the member's scratch for the vertex sum
  float p[kPay], g[9];
  if (live) load_row(s_pay, s_g, p, g);
  const double qnan = (double)__int_as_float(0x7fc00000);
  double e_thread[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    e_thread[m] = 0.0;
    if (m >= here_m) continue;  // the same for the whole block
    float o_in[9], o_out[9];
    if (live) {
      const float e = triangle_energy<kGrad>(a[m], b[m], p, g, k, ok, o_in, o_out);
      e_thread[m] = ok ? (double)e : qnan;
    }
    if constexpr (kGrad) {
      if (m > 0) __syncthreads();  // the last member's sums have read the corner slab
      if (live) {
        float2* row = reinterpret_cast<float2*>(s_corner + tid * 3 * kCorner);
        float2* out = reinterpret_cast<float2*>(corners + (m * (int64_t)n + t) * 3 * kCorner);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float2 x = make_float2(o_in[3 * c], o_in[3 * c + 1]);
          const float2 y = make_float2(o_in[3 * c + 2], o_out[3 * c]);
          const float2 z = make_float2(o_out[3 * c + 1], o_out[3 * c + 2]);
          row[3 * c] = x;
          row[3 * c + 1] = y;
          row[3 * c + 2] = z;
          if (mask & (1u << c)) {
            out[3 * c] = x;
            out[3 * c + 1] = y;
            out[3 * c + 2] = z;
          }
        }
      }
      __syncthreads();
      if (corner_mask == nullptr) {  // every corner: the slab to the scratch, coalesced
        store_slab(corners + (m * (int64_t)n + first) * 3 * kCorner, s_corner,
                   here * 3 * kCorner);
      }
      // interior vertices: ((0 + c_0) + c_1) + ... over the vertex's corners
      // in CSR slot order, as the vertex sum adds
      float* gin_m = gin + m * nv * 3;
      float* gout_m = gout + m * nv * 3;
      if (iv >= 0) {
        vertex_sum::add_interior<float, kCorner>(s_corner, i_ahead, slots, i_lo, i_hi, 3 * first,
                                                 gin_m + 3 * (int64_t)iv,
                                                 gout_m + 3 * (int64_t)iv);
      }
      for (int j = interior_lo + tid + (iv >= 0 ? kThreads : 0); j < interior_hi;
           j += kThreads) {
        const int v = tile_vertices[j];
        int lo, hi, ahead[vertex_sum::kAhead];
        vertex_sum::read_interior(v, offsets, slots, 3 * first, lo, hi, ahead);
        vertex_sum::add_interior<float, kCorner>(s_corner, ahead, slots, lo, hi, 3 * first,
                                                 gin_m + 3 * (int64_t)v, gout_m + 3 * (int64_t)v);
      }
    }
  }

  // 4. each member's energy: block partials, added in block order by the
  // group's last block
  double total[kM];
  if (block_sum::grid_sums<kThreads, kM>(e_thread, here_m, partials, counter, total)) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      if (m < here_m) energy[m] = (float)total[m];
    }
  }
}

// The largest group of members a block takes (frozen_tilt_members' ``group``).
constexpr int kMaxGroup = 4;

struct Launch {
  const float* tin;
  const float* tout;
  const int64_t* rows;
  const int32_t* offsets;
  const int32_t* slots;
  const int32_t* tile_vertices;
  const int32_t* tile_offsets;
  const uint8_t* corner_mask;
  const uint8_t* interior;
  const float* grad_p1;
  const float* pay;
  const float* kv;
  float* corners;
  double* partials;
  unsigned int* counter;
  float* energy;
  float* gin;
  float* gout;
  int n, nv, members;
  int64_t g_stride, pay_stride;
  cudaStream_t stream;
};

// The triangle pass in groups of kM members and, with the gradient, the
// vertex sum of every member's boundary vertices in the corner CSR's order.
template <bool kGrad, int kM, bool kShared>
void run(const Launch& c) {
  const size_t smem = sizeof(float) * (kPaySlab + kGSlab + (kGrad ? kCornerSlab : 0));
  const auto kernel = frozen_tilt_kernel<kGrad, kM, kShared>;
  const dim3 grid((unsigned int)((c.n + kThreads - 1) / kThreads),
                  (unsigned int)((c.members + kM - 1) / kM));
  kernel<<<grid, kThreads, smem, c.stream>>>(
      c.tin, c.tout, c.rows, c.grad_p1, c.pay, c.kv, c.offsets, c.slots, c.tile_vertices,
      c.tile_offsets, c.corner_mask, c.corners, c.gin, c.gout, c.partials, c.counter, c.energy,
      c.n, c.nv, c.members, c.g_stride, c.pay_stride);
  if constexpr (kGrad) {
    vertex_sum::launch_pairs<float>(c.offsets, c.slots, c.corners, c.interior, c.gin, c.gout,
                                    c.nv, c.stream, c.members, 3 * (int64_t)c.n);
  }
}

// Groups of more than one member only with g and the payload shared.
template <bool kGrad>
int run_group(const Launch& c, int group) {
  if (c.g_stride != 0 || c.pay_stride != 0) {
    if (group != 1) return (int)cudaErrorInvalidValue;
    run<kGrad, 1, false>(c);
    return (int)cudaGetLastError();
  }
  switch (group) {
    case 1: run<kGrad, 1, true>(c); break;
    case 2: run<kGrad, 2, true>(c); break;
    case 3: run<kGrad, 3, true>(c); break;
    case 4: run<kGrad, 4, true>(c); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  ``grad`` 0: the energy alone
// (one launch); 1: the energy and the (N, 3) vertex gradients (two launches:
// the triangle pass writes every corner's row to the (T, 3, 6) ``corners``
// scratch, per corner dE/dt_in xyz then dE/dt_out xyz, and the vertex sum
// adds them; a single launch is one wave, which the in-tile sums of
// frozen_tilt_members would lengthen).  partials holds one double per block
// of 128 triangles, counter one zeroed uint32.  Launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for n < 1).
extern "C" int frozen_tilt_vertex(const float* tin, const float* tout, const int64_t* rows,
                                  const int32_t* offsets, const int32_t* slots,
                                  const float* grad_p1, const float* pay, const float* kv,
                                  float* corners, double* partials, unsigned int* counter,
                                  float* energy, float* gin, float* gout, int n, int nv, int grad,
                                  void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const Launch c{tin,     tout,     rows,    offsets, slots,  nullptr, nullptr, nullptr,
                 nullptr, grad_p1,  pay,     kv,      corners, partials, counter, energy,
                 gin,     gout,     n,       nv,      1,      0,       0,
                 (cudaStream_t)stream};
  return grad ? run_group<true>(c, 1) : run_group<false>(c, 1);
}

// frozen_tilt_vertex over ``members`` stacked tilt pairs in one launch (two
// with the gradient), ``group`` members a block (1 to kMaxGroup, more than
// one only with g and the payload shared; the last group may hold fewer): tin
// and tout (members, nv, 3); g and the payload at ``g_stride`` and
// ``pay_stride`` floats per member (0: shared, copied once a block); partials (members, blocks of 128 triangles), counter (members,)
// zeroed (left at zero), energy (members,); with ``grad``, corners
// (members, T, 3, 6) scratch (the boundary corners' rows) and gin / gout
// (members, nv, 3), and the tile tables (kernels/vertex_sum.tile_sums):
// tile_vertices, tile_offsets, corner_mask and interior.  rows, the CSR, the
// tables and kv are shared.  Member m is the bits of
// frozen_tilt_vertex on member m alone, at any group.  cudaErrorInvalidValue
// for n < 1, members < 1 or another group.
extern "C" int frozen_tilt_members(const float* tin, const float* tout, const int64_t* rows,
                                   const int32_t* offsets, const int32_t* slots,
                                   const int32_t* tile_vertices, const int32_t* tile_offsets,
                                   const uint8_t* corner_mask, const uint8_t* interior,
                                   const float* grad_p1, const float* pay, const float* kv,
                                   float* corners, double* partials, unsigned int* counter,
                                   float* energy, float* gin, float* gout, int n, int nv,
                                   int members, int group, int64_t g_stride, int64_t pay_stride,
                                   int grad, void* stream) {
  if (n < 1 || members < 1) return (int)cudaErrorInvalidValue;
  const Launch c{tin, tout, rows, offsets, slots, tile_vertices, tile_offsets, corner_mask,
                 interior, grad_p1, pay, kv, corners, partials, counter, energy, gin, gout, n,
                 nv, members, g_stride, pay_stride, (cudaStream_t)stream};
  return grad ? run_group<true>(c, group) : run_group<false>(c, group);
}

// Triangles per block, for the caller's partials buffer.
extern "C" int frozen_tilt_block_size() { return kThreads; }

// The largest ``group`` frozen_tilt_members takes.
extern "C" int frozen_tilt_max_group() { return kMaxGroup; }
