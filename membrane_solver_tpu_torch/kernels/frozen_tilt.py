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
``LAUNCHES`` counts the energy-only and energy-plus-gradient calls, and the
member-axis energy launches.

The member axis: :func:`frozen_tilt_energy_members` takes B stacked tilt
pairs (B, N, 3) with g and the payload shared ((T, 3, 3), (T, 20)) or one
per member ((B, T, 3, 3), (B, T, 20)), and evaluates every member's energy,
and with a tilt that requires grad both vertex gradients, in one
``frozen_tilt_members`` call: a block takes one tile of triangles for a
group of members (:func:`group_size`), reads the tile's rows once and
copies shared g and payload slabs once for the group.  With the gradient,
the block sums its tile's interior vertices itself and sends only the
other corners through the scratch to the vertex sum
(:func:`~membrane_solver_tpu_torch.kernels.vertex_sum.tile_sums`, kept per
topology on the CSR).  Member m is the bits of the single call on
member m.  Its backward scales each
member's gradients.  The member-batched leaflet relax
(``runtime/tilt_relax``) calls it directly; under ``torch.func.vmap`` over
the tilts (the batched line search's candidates) the single entry point's
``vmap`` rule routes to it, g and the payload mapped or shared, the rows
and k_vec shared.  On the CPU its twin, :func:`reference_members`, runs
the single twin once per member on its own contiguous copies.

Inputs: t_in, t_out (N, 3) vertex tilts; tri_rows (T, 3) int64; the
topology's :class:`~membrane_solver_tpu_torch.device.state.CornerCSR`; g
(T, 3, 3) P1 shape gradients; payload (T, 20) = [A_in, A_out, base_in(3),
va_in(3), base_out(3), va_out(3), w_in(3), w_out(3)]; k_vec (6,) = [k_in,
k_out, kappa_in, kappa_out, ks_in, ks_out].
"""

from __future__ import annotations

import ctypes

import torch

from membrane_solver_tpu_torch.device import shard as _shard
from membrane_solver_tpu_torch.device.reduce import own
from membrane_solver_tpu_torch.device.state import CornerCSR
from membrane_solver_tpu_torch.kernels import _build, _launch
from membrane_solver_tpu_torch.kernels import vertex_sum as vs
from membrane_solver_tpu_torch.kernels.tri_kernels import _member_dim

LAUNCHES = {"energy": 0, "energy_grad": 0, "energy_members": 0, "energy_grad_members": 0}

KERNEL = _build.Source("frozen_tilt")
SOURCE = KERNEL.path
BLOCK = vs.TILE  # triangles per block: one energy partial each (csrc/frozen_tilt.cu kThreads)
CORNER = 6  # floats of a corner-gradient row (csrc/frozen_tilt.cu kCorner)
# members a block of the member launch takes at most (g and the payload shared): the fastest
# at kozlov L3 on an H100 (PERF.md); the kernel is built for groups of 1 to its kMaxGroup
MAX_GROUP = 4

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


def _member_of(x, m: int, single_dims: int):
    """Member m's operand: ``x`` itself when shared (``single_dims`` axes), else its own copy."""
    return x if x.dim() == single_dims else own(x[m])


def reference_members(t_in, t_out, tri_rows, csr, g, payload, k_vec, grad: bool = False):
    """Plain twin of ``frozen_tilt_members``: ((B,) energies, (B, N, 3) dE/dt_in, dE/dt_out) of
    (B, N, 3) tilt pairs, the gradients None without ``grad``.  g and the payload are shared
    ((T, 3, 3), (T, 20)) or per member ((B, T, 3, 3), (B, T, 20)).  The single twin runs once per
    member on its own contiguous copies (the single call's bits)."""
    outs = [reference_vertex(own(t_in[m]), own(t_out[m]), tri_rows, csr, _member_of(g, m, 3),
                             _member_of(payload, m, 2), k_vec, grad)
            for m in range(t_in.shape[0])]
    e = torch.stack([o[0] for o in outs])
    if not grad:
        return e, None, None
    return e, torch.stack([o[1] for o in outs]), torch.stack([o[2] for o in outs])


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
    lib.frozen_tilt_vertex.argtypes = [ptr] * 14 + [i32, i32, i32, ptr]
    lib.frozen_tilt_vertex.restype = i32
    lib.frozen_tilt_members.argtypes = [ptr] * 18 + [i32, i32, i32, i32, ctypes.c_int64,
                                                      ctypes.c_int64, i32, ptr]
    lib.frozen_tilt_members.restype = i32
    lib.frozen_tilt_block_size.restype = i32
    lib.frozen_tilt_max_group.restype = i32
    if lib.frozen_tilt_block_size() != BLOCK:
        raise RuntimeError(f"frozen_tilt.cu uses {lib.frozen_tilt_block_size()}-triangle blocks, "
                           f"the wrapper {BLOCK}")
    if lib.frozen_tilt_max_group() < MAX_GROUP:
        raise RuntimeError(f"frozen_tilt.cu takes groups of up to {lib.frozen_tilt_max_group()} "
                           f"members, the wrapper {MAX_GROUP}")
    _lib = lib
    return lib


class Workspace:
    """Scratch of the CUDA entry point for T triangles, allocated once per relax.

    The (T, 3, 6) corner-gradient rows (per corner dE/dt_in xyz, then dE/dt_out
    xyz; a member gradient launch writes those of boundary vertices, ``vertex_sum.tile_sums``),
    one double energy partial per block of ``BLOCK`` triangles, and the
    last-block counter (zeroed here; each launch leaves it at zero).
    Calls that share a workspace must run in order on one stream.
    """

    def __init__(self, n_triangles: int, device):
        self.n_triangles = n_triangles
        self.corners = torch.empty((n_triangles, 3, CORNER), dtype=torch.float32, device=device)
        self.partials = torch.empty(-(-n_triangles // BLOCK), dtype=torch.float64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self._members = {}

    def member_scratch(self, members: int, grad: bool = False) -> tuple:
        """(partials (B, blocks), counters (B,), corners) of a ``frozen_tilt_members`` launch of
        B members, made at the first such launch and kept (each launch leaves the counters at
        zero); the (B, T, 3, 6) corner rows are None until a gradient launch."""
        device = self.partials.device
        partials, counters, corners = self._members.get(members, (None,) * 3)
        if partials is None:
            partials = torch.empty((members, self.partials.shape[0]), dtype=torch.float64,
                                   device=device)
            counters = torch.zeros(members, dtype=torch.int32, device=device)
        if grad and corners is None:
            corners = torch.empty((members,) + tuple(self.corners.shape), dtype=torch.float32,
                                  device=device)
        self._members[members] = (partials, counters, corners)
        return self._members[members]


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


def _tile_pointers(csr: CornerCSR, grad: bool) -> tuple:
    """A member call's CSR and tile-table pointers (None without ``grad``)."""
    if not grad:
        return (None,) * 6
    ts = vs.tile_sums(csr)
    return (csr.offsets.data_ptr(), csr.slots.data_ptr(), ts.tile_vertices.data_ptr(),
            ts.tile_offsets.data_ptr(), ts.corner_mask.data_ptr(), ts.interior.data_ptr())


def launch(t_in, t_out, tri_rows, csr: CornerCSR, g, payload, k_vec, ws: Workspace, grad: bool):
    """(energy (1,), dE/dt_in (N, 3), dE/dt_out (N, 3)) from one call; gradients None without
    ``grad``.  Every corner row goes through the scratch to the vertex sum."""
    N, T = _check_inputs(t_in, t_out, tri_rows, g, payload, k_vec)
    if ws.n_triangles != T or ws.corners.device != t_in.device:
        raise ValueError(f"the workspace holds {ws.n_triangles} triangles on {ws.corners.device}")
    if grad:
        vs.check_csr(csr, t_in, T)
        if csr.n_rows != N:
            raise ValueError(f"the CSR covers {csr.n_rows} vertex rows, the tilts {N}")
    lib = build()
    energy = torch.empty(1, dtype=torch.float32, device=t_in.device)
    gin = torch.empty_like(t_in) if grad else None
    gout = torch.empty_like(t_out) if grad else None
    code = _launch.call(
        t_in, lib.frozen_tilt_vertex,
        t_in.data_ptr(), t_out.data_ptr(), tri_rows.data_ptr(),
        csr.offsets.data_ptr() if grad else None, csr.slots.data_ptr() if grad else None,
        g.data_ptr(), payload.data_ptr(), k_vec.data_ptr(), ws.corners.data_ptr(),
        ws.partials.data_ptr(), ws.counter.data_ptr(), energy.data_ptr(),
        gin.data_ptr() if grad else None, gout.data_ptr() if grad else None,
        T, N, int(grad),
    )
    if code != 0:
        raise RuntimeError(f"frozen_tilt_vertex launch failed: cudaError {code}")
    if grad:
        _count("energy_grad", t_in, csr)
        vs.count("vertex_sum", t_in, csr)
    else:
        _count("energy", t_in, csr)
    return energy, gin, gout


def _member_stride(x, members: int, single: tuple, name: str) -> int:
    """The member stride (in floats) of a shared (``single`` shape) or per-member input."""
    if tuple(x.shape) == single:
        return 0
    if tuple(x.shape) != (members,) + single or not x.is_contiguous():
        raise ValueError(f"{name} must be {single} (shared) or a contiguous "
                         f"{(members,) + single} (per member), got {tuple(x.shape)}")
    return x.stride(0)


def group_size(members: int, shared: bool = True) -> int:
    """Members a block of a B-member launch takes.  With g and the payload shared and B above
    ``MAX_GROUP``: as few groups of at most ``MAX_GROUP`` as hold B, as even as they go (B = 9:
    3 x 3; B = 11: 4, 4, 3).  Otherwise one: per-member inputs share only the rows, and a few
    members fill more of the card one a block (PERF.md)."""
    if not shared or members <= MAX_GROUP:
        return 1
    groups = -(-members // MAX_GROUP)
    return -(-members // groups)


def launch_members(t_in, t_out, tri_rows, csr: CornerCSR, g, payload, k_vec, ws: Workspace,
                   grad: bool = False):
    """((B,) energies, (B, N, 3) dE/dt_in, dE/dt_out) of B stacked tilt pairs (B, N, 3) in one
    ``frozen_tilt_members`` call; the gradients None without ``grad``.

    g and the payload are shared ((T, 3, 3), (T, 20)) or one per member ((B, T, 3, 3),
    (B, T, 20), contiguous).  With the gradient, each tile's interior vertices are summed in
    the triangle pass (``vertex_sum.tile_sums``).  Member m is the bits of :func:`launch` on member m.
    """
    if t_in.dim() != 3 or t_out.shape != t_in.shape:
        raise ValueError(f"member tilts must be two (B, N, 3) tensors, got "
                         f"{tuple(t_in.shape)} and {tuple(t_out.shape)}")
    members = t_in.shape[0]
    if not 1 <= members <= vs.MAX_MEMBERS:
        raise ValueError(f"{members} members; the launch takes 1 to {vs.MAX_MEMBERS}")
    T = tri_rows.shape[0]
    g_stride = _member_stride(g, members, (T, 3, 3), "g")
    pay_stride = _member_stride(payload, members, (T, 20), "payload")
    N, T = _check_inputs(t_in[0], t_out[0], tri_rows, g[0] if g_stride else g,
                         payload[0] if pay_stride else payload, k_vec)
    if not (t_in.is_contiguous() and t_out.is_contiguous()):
        raise ValueError("member tilts must be contiguous")
    if ws.n_triangles != T or ws.corners.device != t_in.device:
        raise ValueError(f"the workspace holds {ws.n_triangles} triangles on {ws.corners.device}")
    if grad:
        vs.check_csr(csr, t_in, T)
        if csr.n_rows != N:
            raise ValueError(f"the CSR covers {csr.n_rows} vertex rows, the tilts {N}")
    lib = build()
    partials, counter, corners = ws.member_scratch(members, grad)
    energy = torch.empty(members, dtype=torch.float32, device=t_in.device)
    gin = torch.empty_like(t_in) if grad else None
    gout = torch.empty_like(t_out) if grad else None
    code = _launch.call(
        t_in, lib.frozen_tilt_members,
        t_in.data_ptr(), t_out.data_ptr(), tri_rows.data_ptr(), *_tile_pointers(csr, grad),
        g.data_ptr(), payload.data_ptr(), k_vec.data_ptr(),
        corners.data_ptr() if grad else None, partials.data_ptr(), counter.data_ptr(),
        energy.data_ptr(),
        gin.data_ptr() if grad else None, gout.data_ptr() if grad else None,
        T, N, members, group_size(members, g_stride == 0 and pay_stride == 0), g_stride,
        pay_stride, int(grad),
    )
    if code != 0:
        raise RuntimeError(f"frozen_tilt_members launch failed: cudaError {code}")
    if grad:
        _count("energy_grad_members", t_in, csr)
        vs.count("vertex_sum_members", t_in, csr)
    else:
        _launch.count(LAUNCHES, "frozen_tilt", "energy_members", t_in)
    return energy, gin, gout


def _count(key: str, like: torch.Tensor, csr: CornerCSR) -> None:
    _launch.count(LAUNCHES, "frozen_tilt", key, like, csr)


def _evaluate(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws, grad):
    if t_in.is_cuda:
        if ws is None:
            ws = Workspace(tri_rows.shape[0], t_in.device)
        e, gin, gout = launch(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws, grad)
        return e.reshape(()), gin, gout
    return reference_vertex(t_in, t_out, tri_rows, csr, g, payload, k_vec, grad)


def _evaluate_members(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws, grad):
    """((B,) energies, gradients or None) of (B, N, 3) tilt pairs: one member call on the card,
    the twin on the CPU."""
    if t_in.is_cuda:
        if ws is None:
            ws = Workspace(tri_rows.shape[0], t_in.device)
        return launch_members(t_in.contiguous(), t_out.contiguous(), tri_rows, csr,
                              g.contiguous(), payload.contiguous(), k_vec, ws, grad)
    return reference_members(t_in, t_out, tri_rows, csr, g, payload, k_vec, grad)


class _FrozenTiltEnergy(torch.autograd.Function):
    """The energy and both vertex gradients from one call; the backward scales them."""

    @staticmethod
    def forward(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws):
        return _evaluate(t_in.detach(), t_out.detach(), tri_rows, csr, g, payload, k_vec, ws,
                         True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _e, gin, gout = output
        ctx.mark_non_differentiable(gin, gout)
        ctx.save_for_backward(gin, gout)

    @staticmethod
    def backward(ctx, ct, _ct_gin, _ct_gout):
        gin, gout = ctx.saved_tensors
        return ct * gin, ct * gout, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, t_in, t_out, tri_rows, csr, g, payload, k_vec, ws):
        """Every member in one member call: the tilts, g and the payload mapped or shared, the
        rows and k_vec shared; the gradient when a tilt requires it (each member's gradient its
        own single call's, scaled by its own cotangent)."""
        for name, index in (("tri_rows", 2), ("k_vec", 6)):
            if in_dims[index] is not None:
                raise NotImplementedError(
                    f"the member-axis frozen-tilt launch shares {name} across members; "
                    "it varies here")
        a = _member_dim(in_dims, info.batch_size, t_in, 0)
        b = _member_dim(in_dims, info.batch_size, t_out, 1)
        gm = g if in_dims[4] is None else g.movedim(in_dims[4], 0)
        pm = payload if in_dims[5] is None else payload.movedim(in_dims[5], 0)
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            e, gin, gout = _FrozenTiltEnergyMembers.apply(a, b, tri_rows, csr, gm, pm, k_vec, ws)
            return (e, gin, gout), (0, 0, 0)
        e, _gin, _gout = _evaluate_members(a, b, tri_rows, csr, gm, pm, k_vec, ws, False)
        return (e, None, None), (0, None, None)


class _FrozenTiltEnergyMembers(torch.autograd.Function):
    """(B,) energies and both (B, N, 3) vertex gradients from one member call; the backward
    scales each member's gradients by its own cotangent."""

    @staticmethod
    def forward(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws):
        return _evaluate_members(t_in.detach(), t_out.detach(), tri_rows, csr, g, payload, k_vec,
                                 ws, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _e, gin, gout = output
        ctx.mark_non_differentiable(gin, gout)
        ctx.save_for_backward(gin, gout)

    @staticmethod
    def backward(ctx, ct, _ct_gin, _ct_gout):
        gin, gout = ctx.saved_tensors
        ct = ct[:, None, None]
        return ct * gin, ct * gout, None, None, None, None, None, None


def frozen_tilt_energy_members(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws=None):
    """(B,) frozen-tilt energies of (B, N, 3) tilt pairs, differentiable in ``t_in`` and ``t_out``.

    g and the payload are shared ((T, 3, 3), (T, 20)) or one per member ((B, T, 3, 3),
    (B, T, 20)).  When autograd needs a tilt gradient, one member call computes every member's
    energy and both vertex gradients, and the backward scales each member's; otherwise the call
    computes the energies alone.  Member m is the bits of :func:`frozen_tilt_energy` on member
    m's tilts, g and payload.
    """
    if torch.is_grad_enabled() and (t_in.requires_grad or t_out.requires_grad):
        return _FrozenTiltEnergyMembers.apply(t_in, t_out, tri_rows, csr, g, payload, k_vec,
                                              ws)[0]
    return _evaluate_members(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws, False)[0]


def _shard_workspace(topo, t_in) -> Workspace | None:
    """A shard topology's :class:`Workspace` on ``t_in``'s card, kept with it; None on the CPU."""
    if not t_in.is_cuda:
        return None
    return topo.kept(("frozen_tilt.workspace", t_in.device),
                     lambda: Workspace(topo.tri_rows.shape[0], t_in.device))


def frozen_tilt_energy(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws=None):
    """Scalar frozen-tilt energy of vertex tilts, differentiable in ``t_in`` and ``t_out``.

    When autograd needs a tilt gradient, one call computes the energy and
    both vertex gradients and the backward scales them; otherwise the call
    computes the energy alone.  ``ws`` is a :class:`Workspace` for the CUDA
    path (made per call when None).  A ``csr`` that carries a shard plan (``device/shard``)
    runs each shard's triangles on its device, each with a workspace kept on its topology.
    Under ``torch.func.vmap`` over the tilts, every member's energy comes from one member
    launch (the module docstring's member axis).
    """
    if vs.batched(t_in) or vs.batched(t_out):
        return _FrozenTiltEnergy.apply(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws)[0]
    plan = _shard.plan_of(csr, t_in, tri_rows)
    if plan is not None:
        return plan.add(plan.map(
            lambda s, ti, to, gs, ps, k: frozen_tilt_energy(
                ti, to, s.topo.tri_rows, s.csr, gs, ps, k, _shard_workspace(s.topo, ti)),
            vertex=(t_in, t_out), tri=(g, payload), shared=(k_vec,)))
    if torch.is_grad_enabled() and (t_in.requires_grad or t_out.requires_grad):
        return _FrozenTiltEnergy.apply(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws)[0]
    e, _gin, _gout = _evaluate(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws, False)
    return e
