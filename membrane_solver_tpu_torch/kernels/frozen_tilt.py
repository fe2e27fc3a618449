"""Fused frozen-tilt energy: CUDA kernel wrapper and its plain-torch twins.

Counterpart of ``membrane_solver_tpu/pallas_kernels/frozen_tilt.py``.  One
pass per triangle evaluates the four triangle-supported frozen tilt
energies of the caveolin/Kozlov lanes (lumped tilt mass of both leaflets,
the two bending-tilt corner forms, and the tilt-smoothness Dirichlet terms
when active); the gradient is analytic.  The kernels live in
``csrc/frozen_tilt.cu`` (with the shared vertex-sum kernel of
``csrc/vertex_sum.cuh``), are compiled with ``nvcc`` for ``sm_90a`` at first
use into ``_build/`` (keyed by a hash of the sources), and are bound with
``ctypes``.

The entry point, :func:`frozen_tilt_energy`, takes vertex tilts: one ctypes
call gathers the corners through ``tri_rows``, sums the energy into one
device scalar and, when a tilt requires grad, scatters the corner gradients
to vertices in the topology's corner-CSR order (no atomics: the same bits
on every run).  Its backward scales the gradients the forward saved and
launches nothing.

Dispatch: CUDA float32 tensors launch the kernels (after shape, contiguity,
alignment and dtype checks); any other CUDA tensor raises.  CPU tensors run
the twins: :func:`reference_energy` and :func:`reference_grads` on gathered
corners, and the vertex-sum twin, in :func:`reference_vertex`.
``LAUNCHES`` counts the energy-only and energy-plus-gradient calls.

Inputs: t_in, t_out (N, 3) vertex tilts; tri_rows (T, 3) int64; the
topology's :class:`~membrane_solver_tpu_torch.device.state.CornerCSR`; g
(T, 3, 3) P1 shape gradients; payload (T, 20) = [A_in, A_out, base_in(3),
va_in(3), base_out(3), va_out(3), w_in(3), w_out(3)]; k_vec (6,) = [k_in,
k_out, kappa_in, kappa_out, ks_in, ks_out].
"""

from __future__ import annotations

import ctypes

import torch

from membrane_solver_tpu_torch.device.state import CornerCSR
from membrane_solver_tpu_torch.kernels import _build
from membrane_solver_tpu_torch.kernels import vertex_sum as vs

LAUNCHES = {"energy": 0, "energy_grad": 0}

KERNEL = _build.Source("frozen_tilt")
SOURCE = KERNEL.path
BLOCK = 128  # triangles per block: one energy partial each (csrc/frozen_tilt.cu kThreads)

_lib = None


# ----------------------------------------------------------------------
# plain-torch twins
# ----------------------------------------------------------------------
def _split(payload, k_vec):
    return (
        payload[:, 0], payload[:, 1], payload[:, 2:5], payload[:, 5:8],
        payload[:, 8:11], payload[:, 11:14], payload[:, 14:17], payload[:, 17:20],
        *k_vec.unbind(),
    )


def reference_energy(tin_c, tout_c, g, payload, k_vec):
    """The scalar frozen-tilt energy of (T, 3, 3) gathered corner tilts."""
    (A_in, A_out, base_in, va_in, base_out, va_out, w_in, w_out,
     k_in, k_out, kap_in, kap_out, ks_in, ks_out) = _split(payload, k_vec)
    sq_in = torch.sum(tin_c * tin_c, dim=(1, 2))
    sq_out = torch.sum(tout_c * tout_c, dim=(1, 2))
    e = 0.5 * k_in * (sq_in / 3.0) * A_in + 0.5 * k_out * (sq_out / 3.0) * A_out
    div_in = torch.sum(tin_c * g, dim=(1, 2))
    div_out = torch.sum(tout_c * g, dim=(1, 2))
    term_in = base_in - div_in[:, None]
    term_out = base_out + div_out[:, None]
    e = e + 0.5 * kap_in * torch.sum(term_in**2 * va_in, dim=1)
    e = e + 0.5 * kap_out * torch.sum(term_out**2 * va_out, dim=1)

    def dir_sq(t):
        d12 = t[:, 1] - t[:, 2]
        d20 = t[:, 2] - t[:, 0]
        d01 = t[:, 0] - t[:, 1]
        return torch.stack(
            [torch.sum(d12 * d12, dim=1), torch.sum(d20 * d20, dim=1),
             torch.sum(d01 * d01, dim=1)],
            dim=1,
        )

    e = e + 0.25 * ks_in * torch.sum(w_in * dir_sq(tin_c), dim=1)
    e = e + 0.25 * ks_out * torch.sum(w_out * dir_sq(tout_c), dim=1)
    return torch.sum(e)


def _dirichlet_grad(t, w, half_k):
    d12 = t[:, 1] - t[:, 2]
    d20 = t[:, 2] - t[:, 0]
    d01 = t[:, 0] - t[:, 1]
    w0, w1, w2 = w[:, 0:1], w[:, 1:2], w[:, 2:3]
    return half_k * torch.stack(
        [w2 * d01 - w1 * d20, w0 * d12 - w2 * d01, w1 * d20 - w0 * d12], dim=1
    )


def reference_grads(tin_c, tout_c, g, payload, k_vec):
    """The corner gradients (dE/dtin_c, dE/dtout_c), each (T, 3, 3)."""
    (A_in, A_out, base_in, va_in, base_out, va_out, w_in, w_out,
     k_in, k_out, kap_in, kap_out, ks_in, ks_out) = _split(payload, k_vec)
    div_in = torch.sum(tin_c * g, dim=(1, 2))
    div_out = torch.sum(tout_c * g, dim=(1, 2))
    s_in = torch.sum((base_in - div_in[:, None]) * va_in, dim=1)
    s_out = torch.sum((base_out + div_out[:, None]) * va_out, dim=1)
    m_in = (k_in * A_in / 3.0)[:, None, None]
    m_out = (k_out * A_out / 3.0)[:, None, None]
    din = m_in * tin_c - (kap_in * s_in)[:, None, None] * g
    dout = m_out * tout_c + (kap_out * s_out)[:, None, None] * g
    return (
        din + _dirichlet_grad(tin_c, w_in, 0.5 * ks_in),
        dout + _dirichlet_grad(tout_c, w_out, 0.5 * ks_out),
    )


def reference_vertex(t_in, t_out, tri_rows, csr, g, payload, k_vec, grad: bool):
    """Plain twin of the entry point: (energy 0-dim, dE/dt_in, dE/dt_out) or (energy, None, None).

    Gathers the corners, evaluates :func:`reference_energy` and, with
    ``grad``, sums :func:`reference_grads` into vertex rows in CSR order
    (``vertex_sum.reference``).
    """
    tin_c, tout_c = t_in[tri_rows], t_out[tri_rows]
    e = reference_energy(tin_c, tout_c, g, payload, k_vec)
    if not grad:
        return e, None, None
    din_c, dout_c = reference_grads(tin_c, tout_c, g, payload, k_vec)
    return e, vs.reference(din_c, csr), vs.reference(dout_c, csr)


# ----------------------------------------------------------------------
# build and launch
# ----------------------------------------------------------------------
def build() -> ctypes.CDLL:
    """Compile the kernels (once per source hash) and load them."""
    global _lib
    if _lib is not None:
        return _lib
    (lib,) = _build.build(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.frozen_tilt_vertex.argtypes = [ptr] * 15 + [i32, i32, i32, ptr]
    lib.frozen_tilt_vertex.restype = i32
    lib.frozen_tilt_block_size.restype = i32
    if lib.frozen_tilt_block_size() != BLOCK:
        raise RuntimeError(f"frozen_tilt.cu uses {lib.frozen_tilt_block_size()}-triangle blocks, "
                           f"the wrapper {BLOCK}")
    _lib = lib
    return lib


class Workspace:
    """Scratch of the CUDA entry point for T triangles, allocated once per relax.

    Two (T, 3, 3) corner-gradient slabs, one double energy partial per block
    of ``BLOCK`` triangles, and the last-block counter (zeroed here; each
    launch leaves it at zero).  Calls that share a workspace must run in
    order on one stream.
    """

    def __init__(self, n_triangles: int, device):
        f32 = {"dtype": torch.float32, "device": device}
        self.n_triangles = n_triangles
        self.din_c = torch.empty((n_triangles, 3, 3), **f32)
        self.dout_c = torch.empty((n_triangles, 3, 3), **f32)
        self.partials = torch.empty(-(-n_triangles // BLOCK), dtype=torch.float64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)


def _check_inputs(t_in, t_out, tri_rows, g, payload, k_vec) -> tuple[int, int]:
    if not t_in.is_cuda:
        raise ValueError(f"the frozen_tilt launch takes CUDA tensors, got {t_in.device}")
    N, T = t_in.shape[0], tri_rows.shape[0]
    if T < 1 or T >= 2**31 or N >= 2**31:
        raise ValueError(f"{T} triangles / {N} vertices: outside the kernel's int range")
    expected = {
        "t_in": (t_in, (N, 3), torch.float32),
        "t_out": (t_out, (N, 3), torch.float32),
        "tri_rows": (tri_rows, (T, 3), torch.int64),
        "g": (g, (T, 3, 3), torch.float32),
        "payload": (payload, (T, 20), torch.float32),
        "k_vec": (k_vec, (6,), torch.float32),
    }
    for name, (x, shape, dtype) in expected.items():
        if x.device != t_in.device:
            raise ValueError(f"{name} must lie on {t_in.device}, got {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"the frozen_tilt kernel takes {dtype} {name}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("g", g), ("payload", payload)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (bulk copies)")
    return N, T


def launch(t_in, t_out, tri_rows, csr: CornerCSR, g, payload, k_vec, ws: Workspace, grad: bool):
    """(energy (1,), dE/dt_in (N, 3), dE/dt_out (N, 3)) from one call; gradients None without ``grad``."""
    N, T = _check_inputs(t_in, t_out, tri_rows, g, payload, k_vec)
    if ws.n_triangles != T or ws.din_c.device != t_in.device:
        raise ValueError(f"the workspace holds {ws.n_triangles} triangles on {ws.din_c.device}")
    if grad:
        vs.check_csr(csr, t_in, T)
        if csr.n_rows != N:
            raise ValueError(f"the CSR covers {csr.n_rows} vertex rows, the tilts {N}")
    lib = build()
    energy = torch.empty(1, dtype=torch.float32, device=t_in.device)
    gin = torch.empty_like(t_in) if grad else None
    gout = torch.empty_like(t_out) if grad else None
    code = lib.frozen_tilt_vertex(
        t_in.data_ptr(), t_out.data_ptr(), tri_rows.data_ptr(),
        csr.offsets.data_ptr() if grad else None, csr.slots.data_ptr() if grad else None,
        g.data_ptr(), payload.data_ptr(), k_vec.data_ptr(), ws.din_c.data_ptr(),
        ws.dout_c.data_ptr(), ws.partials.data_ptr(), ws.counter.data_ptr(), energy.data_ptr(),
        gin.data_ptr() if grad else None, gout.data_ptr() if grad else None,
        T, N, int(grad), torch.cuda.current_stream(t_in.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"frozen_tilt_vertex launch failed: cudaError {code}")
    if grad:
        LAUNCHES["energy_grad"] += 1
        vs.LAUNCHES["vertex_sum"] += 1
    else:
        LAUNCHES["energy"] += 1
    return energy, gin, gout


def _evaluate(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws, grad):
    if t_in.is_cuda:
        if ws is None:
            ws = Workspace(tri_rows.shape[0], t_in.device)
        e, gin, gout = launch(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws, grad)
        return e.reshape(()), gin, gout
    return reference_vertex(t_in, t_out, tri_rows, csr, g, payload, k_vec, grad)


class _FrozenTiltEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t_in, t_out, tri_rows, csr, g, payload, k_vec, ws):
        e, gin, gout = _evaluate(t_in.detach(), t_out.detach(), tri_rows, csr, g, payload, k_vec,
                                 ws, True)
        ctx.save_for_backward(gin, gout)
        return e

    @staticmethod
    def backward(ctx, ct):
        gin, gout = ctx.saved_tensors
        return ct * gin, ct * gout, None, None, None, None, None, None


def frozen_tilt_energy(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws=None):
    """Scalar frozen-tilt energy of vertex tilts, differentiable in ``t_in`` and ``t_out``.

    When autograd needs a tilt gradient, one call computes the energy and
    both vertex gradients and the backward scales them; otherwise the call
    computes the energy alone.  ``ws`` is a :class:`Workspace` for the CUDA
    path (made per call when None).
    """
    if torch.is_grad_enabled() and (t_in.requires_grad or t_out.requires_grad):
        return _FrozenTiltEnergy.apply(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws)
    e, _gin, _gout = _evaluate(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws, False)
    return e
