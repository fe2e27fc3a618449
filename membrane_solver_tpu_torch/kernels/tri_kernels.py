"""Per-triangle geometry kernels: CUDA wrappers, autograd Functions, dispatch.

Counterpart of ``membrane_solver_tpu/pallas_kernels/tri_kernels.py``.  The
kernels live in ``csrc/tri_kernels.cu`` (with the shared vertex-sum and
block-sum kernels of ``csrc/vertex_sum.cuh`` and ``csrc/block_sum.cuh``),
each for float32 and float64, compiled with ``nvcc`` for ``sm_90a`` at
first use (``kernels/_build``) and bound with ``ctypes``.  Entry points on
the solver's path, each one ctypes call:

- ``surface_energy``: the surface energy ``sum_t [valid_t] gamma_t A_t``
  as one device scalar, the tension mask and the sum in the kernel, and,
  when the positions require grad, its vertex gradient summed in
  corner-CSR order (twin: ``geo.surface_corner_terms`` and
  ``vertex_sum.reference``); its backward scales the saved gradient;
- ``curvature_data``: the cotan curvature data of ``geo.curvature_data``:
  cotangent weights and Meyer corner areas per corner, and the corner
  mean-curvature vectors and corner areas summed into vertex rows by the
  vertex-sum kernel in corner-CSR order (twin: ``geo.curvature_corners``
  and ``vertex_sum.reference``);
- ``curvature_data_bwd``: its vector-Jacobian product with respect to the
  positions, from the vertex upstream of ``k_vecs`` and ``vertex_areas``
  (read through ``tri_rows`` in the kernel) and the per-corner upstream of
  the weights and corner areas, summed into vertex rows (twin: autograd of
  ``geo.curvature_corners``, then ``vertex_sum.reference``);
- ``p1_div``: the masked P1 divergence, the masked area and the P1 shape
  gradients of ``tilt_ops.p1_triangle_divergence`` (its twin);
- ``p1_div_bwd``: its backward in the tilts, ``[valid_t] dE/ddiv_t g[t, c]``
  summed into vertex rows in corner-CSR order by the weighted vertex sum
  (twin: :func:`p1_div_vjp_reference`).

``surface_energy_and_gradient`` is the same call without autograd, for the
area constraints (``global_area``, ``body_area``).

Off the solver's path, kept for the tests and the card checks:
``surface_fwd`` and ``curvature_fwd`` / ``curvature_bwd``, the same
kernels with per-triangle outputs and no sums (:func:`curvature_corners`
is the autograd-aware form of the curvature pair).

Each kernel gathers its corners through ``tri_rows`` itself, and every sum
runs in a fixed order (no atomic scatter): two calls give the same bits.

Dispatch: the public functions (:func:`surface_energy`,
:func:`curvature_data`, :func:`p1_triangle_divergence`,
:func:`curvature_corners`) are autograd-aware, and the energy modules call
them in place of the plain ``geo`` / ``tilt_ops`` functions.  A CUDA tensor
launches the kernels, after device, dtype, shape, contiguity and alignment
checks that raise on anything else; a CPU tensor runs the twins.
``LAUNCHES`` counts calls of each entry point; the vertex-sum launches they
make count in ``vertex_sum.LAUNCHES``.

The member axis (the parameter sweep, ``parallel/sweep``): under
``torch.func.vmap`` the Functions' ``vmap`` rules call the ``*_members``
launches (``launch_surface_energy_members``, ``launch_curvature_data_members``
and its backward, ``launch_p1_divergence_members`` and its tilt backward):
one call for B members stacked on a leading axis, the members on the
grid's y axis, ``tri_rows``, the masks and the CSR shared, member m's
outputs the bits of the single call on member m.  Their twins
(``*_members_reference``) run the single twins per member, on the CPU.
The rules raise when a shared input (``tri_rows``, ``tri_valid``) varies
over the members.
"""

from __future__ import annotations

import ctypes

import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device import tilt_ops
from membrane_solver_tpu_torch.device.state import CornerCSR
from membrane_solver_tpu_torch.kernels import _build
from membrane_solver_tpu_torch.kernels import vertex_sum as vs

LAUNCHES = {"surface_energy": 0, "surface_energy_grad": 0, "curvature_data": 0,
            "curvature_data_bwd": 0, "p1_div": 0, "p1_div_bwd": 0,
            "surface_fwd": 0, "curvature_fwd": 0, "curvature_bwd": 0,
            # the member axis (the parameter sweep): one launch for all members
            "surface_energy_members": 0, "surface_energy_grad_members": 0,
            "curvature_data_members": 0, "curvature_data_bwd_members": 0,
            "p1_div_members": 0, "p1_div_bwd_members": 0}

# -fmad=false: no contracted multiply-adds, so the obtuse-branch tests see
# the twin's rounding (see the note in the source)
KERNEL = _build.Source("tri_kernels", extra_flags=("-fmad=false",))
SOURCE = KERNEL.path
TILE = 128  # triangles per block of the surface and divergence kernels (csrc kTile)

_lib = None


def build() -> ctypes.CDLL:
    """Compile the kernels (once per source hash) and load them."""
    global _lib
    if _lib is not None:
        return _lib
    (lib,) = _build.build(KERNEL)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "tri_surface_fwd": [i32, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr],
        "tri_surface_energy": [i32] + [ptr] * 11 + [i32, i64, i32, ptr],
        "tri_curvature_fwd": [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr],
        "tri_curvature_bwd": [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr],
        "tri_curvature_data": [i32] + [ptr] * 10 + [i32, i64, ptr],
        "tri_curvature_data_bwd": [i32] + [ptr] * 11 + [i32, i64, ptr],
        "tri_p1_div": [i32] + [ptr] * 7 + [i32, i64, ptr],
        "tri_p1_div_bwd": [i32] + [ptr] * 6 + [i64, ptr],
        "tri_surface_energy_members": [i32, ptr, ptr, ptr, ptr, i64] + [ptr] * 7
                                      + [i32, i64, i32, i32, ptr],
        "tri_curvature_data_members": [i32] + [ptr] * 10 + [i32, i64, i32, ptr],
        "tri_curvature_data_bwd_members": [i32] + [ptr] * 11 + [i32, i64, i32, ptr],
        "tri_p1_div_members": [i32] + [ptr] * 7 + [i32, i64, i32, ptr],
        "tri_p1_div_bwd_members": [i32] + [ptr] * 6 + [i64, i32, i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.tri_tile_size.restype = i32
    if lib.tri_tile_size() != TILE:
        raise RuntimeError(f"tri_kernels.cu uses {lib.tri_tile_size()}-triangle blocks, "
                           f"the wrapper {TILE}")
    _lib = lib
    return lib


# ----------------------------------------------------------------------
# launches (CUDA tensors only)
# ----------------------------------------------------------------------
def _check(like: torch.Tensor, dtype, **tensors) -> None:
    """Every tensor on ``like``'s CUDA device, contiguous, with its shape and dtype."""
    if not like.is_cuda:
        raise ValueError(f"the tri_kernels launches take CUDA tensors, got {like.device}")
    if like.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the tri_kernels take float32 or float64, got {like.dtype}")
    for name, (x, shape, want_dtype) in tensors.items():
        if x.device != like.device:
            raise ValueError(f"{name} must lie on {like.device}, got {x.device}")
        if x.dtype != (dtype if want_dtype is None else want_dtype):
            raise TypeError(f"{name} is {x.dtype}, expected {want_dtype or dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_rows(positions, tri_rows) -> int:
    T = tri_rows.shape[0]
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (Nv, 3), got {tuple(positions.shape)}")
    if T >= 2**31 or positions.shape[0] >= 2**31:
        raise ValueError(f"{T} triangles / {positions.shape[0]} vertices exceed the kernel's "
                         "int index")
    _check(positions, positions.dtype,
           positions=(positions, positions.shape, None), tri_rows=(tri_rows, (T, 3), torch.int64))
    if tri_rows.data_ptr() % 16:
        raise ValueError("tri_rows must start on a 16-byte boundary (16-byte slab loads)")
    return T


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {code}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _f64(x: torch.Tensor) -> int:
    return int(x.dtype == torch.float64)


def launch_surface(positions, tri_rows, gamma):
    """(e (T,), g (T, 3, 3)) per triangle from ``tri_surface_fwd`` (no mask, no sum)."""
    T = _check_rows(positions, tri_rows)
    _check(positions, positions.dtype, gamma=(gamma, (T,), None))
    lib = build()
    e = torch.empty(T, dtype=positions.dtype, device=positions.device)
    g = torch.empty((T, 3, 3), dtype=positions.dtype, device=positions.device)
    code = lib.tri_surface_fwd(
        _f64(positions), positions.data_ptr(), tri_rows.data_ptr(), gamma.data_ptr(),
        e.data_ptr(), g.data_ptr(), T, positions.shape[0], _stream(positions),
    )
    _raise_on(code, "tri_surface_fwd")
    LAUNCHES["surface_fwd"] += 1
    return e, g


class Workspace:
    """Scratch of ``tri_surface_energy`` for T triangles of one dtype on one card.

    A (T, 3, 3) corner-gradient slab, one double energy partial per block of
    ``TILE`` triangles, and the last-block counter (zeroed here; each launch
    leaves it at zero).  Kept per topology by :func:`workspace`; calls that
    share one must run in order on one stream.
    """

    def __init__(self, n_triangles: int, dtype, device, topo=None):
        self.n_triangles = n_triangles
        self.topo = topo  # the topology that keeps it (its member workspaces too)
        self.corners = torch.empty((n_triangles, 3, 3), dtype=dtype, device=device)
        self.partials = torch.empty(-(-n_triangles // TILE), dtype=torch.float64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)


def workspace(topo, positions) -> Workspace | None:
    """The topology's :class:`Workspace` for ``positions``' dtype and card; None on the CPU.

    Built at first use and kept with the topology (``Topology.kept``), so
    the solver's calls allocate no scratch.
    """
    if not positions.is_cuda:
        return None
    return topo.kept(("tri_kernels.workspace", positions.dtype, positions.device),
                     lambda: Workspace(topo.tri_rows.shape[0], positions.dtype, positions.device,
                                       topo))


def launch_surface_energy(positions, tri_rows, tri_valid, tension, csr: CornerCSR, ws: Workspace,
                          grad: bool):
    """(energy (1,), dE/dpositions (Nv, 3) or None) from one ``tri_surface_energy`` call."""
    T = _check_rows(positions, tri_rows)
    if T < 1:
        raise ValueError("the surface energy kernel needs at least one triangle")
    _check(positions, positions.dtype, tri_valid=(tri_valid, (T,), torch.bool),
           tension=(tension, (T,), None))
    if (ws.n_triangles != T or ws.corners.device != positions.device
            or ws.corners.dtype != positions.dtype):
        raise ValueError(f"the workspace holds {ws.n_triangles} {ws.corners.dtype} triangles on "
                         f"{ws.corners.device}")
    if grad:
        _check_csr(positions, tri_rows, csr)
    lib = build()
    nv = positions.shape[0]
    energy = torch.empty(1, dtype=positions.dtype, device=positions.device)
    dpos = torch.empty((nv, 3), dtype=positions.dtype, device=positions.device) if grad else None
    code = lib.tri_surface_energy(
        _f64(positions), positions.data_ptr(), tri_rows.data_ptr(), tri_valid.data_ptr(),
        tension.data_ptr(), csr.offsets.data_ptr() if grad else None,
        csr.slots.data_ptr() if grad else None, ws.corners.data_ptr(), ws.partials.data_ptr(),
        ws.counter.data_ptr(), energy.data_ptr(), _ptr(dpos), T, nv, int(grad),
        _stream(positions),
    )
    _raise_on(code, "tri_surface_energy")
    if grad:
        LAUNCHES["surface_energy_grad"] += 1
        vs.LAUNCHES["vertex_sum"] += 1
    else:
        LAUNCHES["surface_energy"] += 1
    return energy, dpos


def launch_curvature(positions, tri_rows, tri_valid):
    """(cot (T, 3), k (T, 3, 3), va (T, 3), area (T,)) from ``curvature_fwd``."""
    T = _check_rows(positions, tri_rows)
    _check(positions, positions.dtype, tri_valid=(tri_valid, (T,), torch.bool))
    lib = build()
    kw = {"dtype": positions.dtype, "device": positions.device}
    cot, k, va, area = (torch.empty(s, **kw) for s in ((T, 3), (T, 3, 3), (T, 3), (T,)))
    code = lib.tri_curvature_fwd(
        int(positions.dtype == torch.float64), positions.data_ptr(), tri_rows.data_ptr(),
        tri_valid.data_ptr(), cot.data_ptr(), k.data_ptr(), va.data_ptr(), area.data_ptr(),
        T, positions.shape[0], _stream(positions),
    )
    _raise_on(code, "tri_curvature_fwd")
    LAUNCHES["curvature_fwd"] += 1
    return cot, k, va, area


def launch_curvature_bwd(positions, tri_rows, tri_valid, g_cot, g_k, g_va, g_area):
    """Corner gradients (T, 3, 3) of <upstream, curvature_fwd> from ``curvature_bwd``."""
    T = _check_rows(positions, tri_rows)
    _check(positions, positions.dtype, tri_valid=(tri_valid, (T,), torch.bool),
           g_cot=(g_cot, (T, 3), None), g_k=(g_k, (T, 3, 3), None),
           g_va=(g_va, (T, 3), None), g_area=(g_area, (T,), None))
    lib = build()
    dp = torch.empty((T, 3, 3), dtype=positions.dtype, device=positions.device)
    code = lib.tri_curvature_bwd(
        int(positions.dtype == torch.float64), positions.data_ptr(), tri_rows.data_ptr(),
        tri_valid.data_ptr(), g_cot.data_ptr(), g_k.data_ptr(), g_va.data_ptr(),
        g_area.data_ptr(), dp.data_ptr(), T, positions.shape[0], _stream(positions),
    )
    _raise_on(code, "tri_curvature_bwd")
    LAUNCHES["curvature_bwd"] += 1
    return dp


def _check_csr(positions, tri_rows, csr: CornerCSR) -> None:
    vs.check_csr(csr, positions, tri_rows.shape[0])
    if csr.n_rows != positions.shape[0]:
        raise ValueError(f"the CSR covers {csr.n_rows} vertex rows, the positions "
                         f"{positions.shape[0]}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def launch_curvature_data(positions, tri_rows, tri_valid, csr: CornerCSR):
    """(cot (T, 3), va (T, 3), k_vecs (Nv, 3), vertex_areas (Nv,)) from ``tri_curvature_data``."""
    T = _check_rows(positions, tri_rows)
    _check(positions, positions.dtype, tri_valid=(tri_valid, (T,), torch.bool))
    _check_csr(positions, tri_rows, csr)
    lib = build()
    nv = positions.shape[0]
    kw = {"dtype": positions.dtype, "device": positions.device}
    cot, va, k_scratch, k_vecs, vertex_areas = (
        torch.empty(s, **kw) for s in ((T, 3), (T, 3), (T, 3, 3), (nv, 3), (nv,)))
    code = lib.tri_curvature_data(
        int(positions.dtype == torch.float64), positions.data_ptr(), tri_rows.data_ptr(),
        tri_valid.data_ptr(), csr.offsets.data_ptr(), csr.slots.data_ptr(), cot.data_ptr(),
        va.data_ptr(), k_scratch.data_ptr(), k_vecs.data_ptr(), vertex_areas.data_ptr(),
        T, nv, _stream(positions),
    )
    _raise_on(code, "tri_curvature_data")
    LAUNCHES["curvature_data"] += 1
    vs.LAUNCHES["vertex_sum"] += 1
    return cot, va, k_vecs, vertex_areas


def launch_curvature_data_bwd(positions, tri_rows, tri_valid, csr: CornerCSR, g_kvecs, g_varea,
                              g_cot, g_va):
    """dE/dpositions (Nv, 3) from ``tri_curvature_data_bwd``; any upstream may be None (zero)."""
    T = _check_rows(positions, tri_rows)
    nv = positions.shape[0]
    upstream = {"g_kvecs": (g_kvecs, (nv, 3), None), "g_varea": (g_varea, (nv,), None),
                "g_cot": (g_cot, (T, 3), None), "g_va": (g_va, (T, 3), None)}
    _check(positions, positions.dtype, tri_valid=(tri_valid, (T,), torch.bool),
           **{k: v for k, v in upstream.items() if v[0] is not None})
    _check_csr(positions, tri_rows, csr)
    lib = build()
    dc_scratch = torch.empty((T, 3, 3), dtype=positions.dtype, device=positions.device)
    dpos = torch.empty((nv, 3), dtype=positions.dtype, device=positions.device)
    code = lib.tri_curvature_data_bwd(
        int(positions.dtype == torch.float64), positions.data_ptr(), tri_rows.data_ptr(),
        tri_valid.data_ptr(), csr.offsets.data_ptr(), csr.slots.data_ptr(), _ptr(g_kvecs),
        _ptr(g_varea), _ptr(g_cot), _ptr(g_va), dc_scratch.data_ptr(), dpos.data_ptr(),
        T, nv, _stream(positions),
    )
    _raise_on(code, "tri_curvature_data_bwd")
    LAUNCHES["curvature_data_bwd"] += 1
    vs.LAUNCHES["vertex_sum"] += 1
    return dpos


def launch_p1_divergence(positions, tilts, tri_rows, tri_valid):
    """(div (T,), area (T,), g (T, 3, 3)) from ``tri_p1_div``, masked as
    ``tilt_ops.p1_triangle_divergence`` masks them."""
    T = _check_rows(positions, tri_rows)
    _check(positions, positions.dtype, tilts=(tilts, positions.shape, None),
           tri_valid=(tri_valid, (T,), torch.bool))
    lib = build()
    kw = {"dtype": positions.dtype, "device": positions.device}
    div, area, g = (torch.empty(s, **kw) for s in ((T,), (T,), (T, 3, 3)))
    code = lib.tri_p1_div(
        _f64(positions), positions.data_ptr(), tilts.data_ptr(), tri_rows.data_ptr(),
        tri_valid.data_ptr(), div.data_ptr(), area.data_ptr(), g.data_ptr(), T,
        positions.shape[0], _stream(positions),
    )
    _raise_on(code, "tri_p1_div")
    LAUNCHES["p1_div"] += 1
    return div, area, g


def launch_p1_div_bwd(g, tri_valid, g_div, csr: CornerCSR):
    """dE/dtilts (Nv, 3) = sum over each vertex's CSR slots (t, c) of [valid_t] g_div_t g[t, c]."""
    T = g.shape[0]
    _check(g, g.dtype, g=(g, (T, 3, 3), None), tri_valid=(tri_valid, (T,), torch.bool),
           g_div=(g_div, (T,), None))
    vs.check_csr(csr, g, T)
    lib = build()
    dtilts = torch.empty((csr.n_rows, 3), dtype=g.dtype, device=g.device)
    code = lib.tri_p1_div_bwd(
        _f64(g), csr.offsets.data_ptr(), csr.slots.data_ptr(), g.data_ptr(), tri_valid.data_ptr(),
        g_div.data_ptr(), dtilts.data_ptr(), csr.n_rows, _stream(g),
    )
    _raise_on(code, "tri_p1_div_bwd")
    LAUNCHES["p1_div_bwd"] += 1
    vs.LAUNCHES["vertex_sum"] += 1
    return dtilts


# ----------------------------------------------------------------------
# member-axis launches (the parameter sweep; CUDA tensors only)
# ----------------------------------------------------------------------
def _check_members(positions, tri_rows) -> tuple:
    """(B, T) of (B, Nv, 3) member positions and the shared (T, 3) rows."""
    if positions.dim() != 3 or positions.shape[2] != 3:
        raise ValueError(f"member positions must be (B, Nv, 3), got {tuple(positions.shape)}")
    members = positions.shape[0]
    if not 1 <= members <= vs.MAX_MEMBERS:
        raise ValueError(f"{members} members; the launches take 1 to {vs.MAX_MEMBERS}")
    T = _check_rows(positions[0], tri_rows)
    if not positions.is_contiguous():
        raise ValueError("member positions must be contiguous")
    return members, T


class MemberWorkspace:
    """Scratch of ``tri_surface_energy_members`` for B members of T triangles.

    :class:`Workspace` with a leading member axis: (B, T, 3, 3) corner
    gradients, (B, blocks) double partials and B last-block counters.  Kept
    per topology and member count by :func:`member_workspace`.
    """

    def __init__(self, members: int, n_triangles: int, dtype, device):
        self.members = members
        self.n_triangles = n_triangles
        self.corners = torch.empty((members, n_triangles, 3, 3), dtype=dtype, device=device)
        self.partials = torch.empty((members, -(-n_triangles // TILE)), dtype=torch.float64,
                                    device=device)
        self.counter = torch.zeros(members, dtype=torch.int32, device=device)


def member_workspace(topo, positions) -> MemberWorkspace | None:
    """The topology's :class:`MemberWorkspace` for (B, Nv, 3) ``positions``; None on the CPU."""
    if not positions.is_cuda:
        return None
    members = positions.shape[0]
    return topo.kept(("tri_kernels.member_workspace", positions.dtype, positions.device, members),
                     lambda: MemberWorkspace(members, topo.tri_rows.shape[0], positions.dtype,
                                             positions.device))


def launch_surface_energy_members(positions, tri_rows, tri_valid, tension, csr: CornerCSR,
                                  ws: MemberWorkspace, grad: bool):
    """(energy (B,), dE/dpositions (B, Nv, 3) or None) of B members in one call.

    ``tension`` is (T,), shared, or (B, T); member m's outputs are the bits
    of :func:`launch_surface_energy` on member m.
    """
    members, T = _check_members(positions, tri_rows)
    if T < 1:
        raise ValueError("the surface energy kernel needs at least one triangle")
    shared = tension.dim() == 1
    _check(positions, positions.dtype, tri_valid=(tri_valid, (T,), torch.bool),
           tension=(tension, (T,) if shared else (members, T), None))
    if (ws.members != members or ws.n_triangles != T or ws.corners.device != positions.device
            or ws.corners.dtype != positions.dtype):
        raise ValueError(f"the workspace holds {ws.members} x {ws.n_triangles} "
                         f"{ws.corners.dtype} triangles on {ws.corners.device}")
    if grad:
        _check_csr(positions[0], tri_rows, csr)
    lib = build()
    nv = positions.shape[1]
    energy = torch.empty(members, dtype=positions.dtype, device=positions.device)
    dpos = torch.empty_like(positions) if grad else None
    code = lib.tri_surface_energy_members(
        _f64(positions), positions.data_ptr(), tri_rows.data_ptr(), tri_valid.data_ptr(),
        tension.data_ptr(), 0 if shared else T, csr.offsets.data_ptr() if grad else None,
        csr.slots.data_ptr() if grad else None, ws.corners.data_ptr(), ws.partials.data_ptr(),
        ws.counter.data_ptr(), energy.data_ptr(), _ptr(dpos), T, nv, int(grad), members,
        _stream(positions),
    )
    _raise_on(code, "tri_surface_energy_members")
    if grad:
        LAUNCHES["surface_energy_grad_members"] += 1
        vs.LAUNCHES["vertex_sum_members"] += 1
    else:
        LAUNCHES["surface_energy_members"] += 1
    return energy, dpos


def launch_curvature_data_members(positions, tri_rows, tri_valid, csr: CornerCSR):
    """(cot (B, T, 3), va (B, T, 3), k_vecs (B, Nv, 3), vertex_areas (B, Nv)) in one call."""
    members, T = _check_members(positions, tri_rows)
    _check(positions, positions.dtype, tri_valid=(tri_valid, (T,), torch.bool))
    _check_csr(positions[0], tri_rows, csr)
    lib = build()
    nv = positions.shape[1]
    kw = {"dtype": positions.dtype, "device": positions.device}
    cot, va, k_scratch, k_vecs, vertex_areas = (
        torch.empty((members,) + s, **kw) for s in ((T, 3), (T, 3), (T, 3, 3), (nv, 3), (nv,)))
    code = lib.tri_curvature_data_members(
        _f64(positions), positions.data_ptr(), tri_rows.data_ptr(), tri_valid.data_ptr(),
        csr.offsets.data_ptr(), csr.slots.data_ptr(), cot.data_ptr(), va.data_ptr(),
        k_scratch.data_ptr(), k_vecs.data_ptr(), vertex_areas.data_ptr(), T, nv, members,
        _stream(positions),
    )
    _raise_on(code, "tri_curvature_data_members")
    LAUNCHES["curvature_data_members"] += 1
    vs.LAUNCHES["vertex_sum_members"] += 1
    return cot, va, k_vecs, vertex_areas


def launch_curvature_data_bwd_members(positions, tri_rows, tri_valid, csr: CornerCSR, g_kvecs,
                                      g_varea, g_cot, g_va):
    """dE/dpositions (B, Nv, 3) of B members in one call; any upstream may be None (zero)."""
    members, T = _check_members(positions, tri_rows)
    nv = positions.shape[1]
    upstream = {"g_kvecs": (g_kvecs, (members, nv, 3), None),
                "g_varea": (g_varea, (members, nv), None),
                "g_cot": (g_cot, (members, T, 3), None), "g_va": (g_va, (members, T, 3), None)}
    _check(positions, positions.dtype, tri_valid=(tri_valid, (T,), torch.bool),
           **{k: v for k, v in upstream.items() if v[0] is not None})
    _check_csr(positions[0], tri_rows, csr)
    lib = build()
    dc_scratch = torch.empty((members, T, 3, 3), dtype=positions.dtype, device=positions.device)
    dpos = torch.empty_like(positions)
    code = lib.tri_curvature_data_bwd_members(
        _f64(positions), positions.data_ptr(), tri_rows.data_ptr(), tri_valid.data_ptr(),
        csr.offsets.data_ptr(), csr.slots.data_ptr(), _ptr(g_kvecs), _ptr(g_varea), _ptr(g_cot),
        _ptr(g_va), dc_scratch.data_ptr(), dpos.data_ptr(), T, nv, members, _stream(positions),
    )
    _raise_on(code, "tri_curvature_data_bwd_members")
    LAUNCHES["curvature_data_bwd_members"] += 1
    vs.LAUNCHES["vertex_sum_members"] += 1
    return dpos


def launch_p1_divergence_members(positions, tilts, tri_rows, tri_valid):
    """(div (B, T), area (B, T), g (B, T, 3, 3)) of B members in one call."""
    members, T = _check_members(positions, tri_rows)
    _check(positions, positions.dtype, tilts=(tilts, positions.shape, None),
           tri_valid=(tri_valid, (T,), torch.bool))
    lib = build()
    kw = {"dtype": positions.dtype, "device": positions.device}
    div, area, g = (torch.empty((members,) + s, **kw) for s in ((T,), (T,), (T, 3, 3)))
    code = lib.tri_p1_div_members(
        _f64(positions), positions.data_ptr(), tilts.data_ptr(), tri_rows.data_ptr(),
        tri_valid.data_ptr(), div.data_ptr(), area.data_ptr(), g.data_ptr(), T,
        positions.shape[1], members, _stream(positions),
    )
    _raise_on(code, "tri_p1_div_members")
    LAUNCHES["p1_div_members"] += 1
    return div, area, g


def launch_p1_div_bwd_members(g, tri_valid, g_div, csr: CornerCSR):
    """dE/dtilts (B, Nv, 3) of B members' (B, T, 3, 3) shape gradients in one call."""
    if g.dim() != 4:
        raise ValueError(f"member shape gradients must be (B, T, 3, 3), got {tuple(g.shape)}")
    members, T = g.shape[0], g.shape[1]
    if not 1 <= members <= vs.MAX_MEMBERS:
        raise ValueError(f"{members} members; the launches take 1 to {vs.MAX_MEMBERS}")
    _check(g, g.dtype, g=(g, (members, T, 3, 3), None), tri_valid=(tri_valid, (T,), torch.bool),
           g_div=(g_div, (members, T), None))
    vs.check_csr(csr, g, T)
    lib = build()
    dtilts = torch.empty((members, csr.n_rows, 3), dtype=g.dtype, device=g.device)
    code = lib.tri_p1_div_bwd_members(
        _f64(g), csr.offsets.data_ptr(), csr.slots.data_ptr(), g.data_ptr(), tri_valid.data_ptr(),
        g_div.data_ptr(), dtilts.data_ptr(), csr.n_rows, T, members, _stream(g),
    )
    _raise_on(code, "tri_p1_div_bwd_members")
    LAUNCHES["p1_div_bwd_members"] += 1
    vs.LAUNCHES["vertex_sum_members"] += 1
    return dtilts


# ----------------------------------------------------------------------
# plain twins and autograd Functions (kernels on the card, twins on the CPU)
# ----------------------------------------------------------------------
def _corners(x, tri_rows):
    return x[tri_rows[:, 0]], x[tri_rows[:, 1]], x[tri_rows[:, 2]]


def surface_energy_reference(positions, tri_rows, tri_valid, tension, csr: CornerCSR, grad: bool):
    """Plain twin of ``tri_surface_energy``: (energy 0-dim, dE/dpositions or None)."""
    gamma = torch.where(tri_valid, tension, 0.0)
    e, g0, g1, g2 = dgeo.surface_corner_terms(*_corners(positions, tri_rows), gamma)
    dpos = vs.reference(torch.stack([g0, g1, g2], dim=1), csr) if grad else None
    return torch.sum(e), dpos


def p1_div_vjp_reference(g, tri_valid, g_div, csr: CornerCSR):
    """Plain twin of ``tri_p1_div_bwd``: the weighted vertex sum of the shape gradients."""
    return vs.reference(g, csr, weight=torch.where(tri_valid, g_div, 0.0))


def curvature_corners_vjp(positions, tri_rows, tri_valid, g_cot, g_k, g_va, g_area):
    """Plain twin of ``curvature_bwd``: autograd of ``geo.curvature_corners``."""
    corners = [c.detach().requires_grad_(True) for c in _corners(positions, tri_rows)]
    with torch.enable_grad():
        cot, k0, k1, k2, va, area = dgeo.curvature_corners(*corners, tri_valid)
        grads = torch.autograd.grad(
            (cot, k0, k1, k2, va, area), corners,
            (g_cot, g_k[:, 0], g_k[:, 1], g_k[:, 2], g_va, g_area),
        )
    return torch.stack(grads, dim=1)


def curvature_data_reference(positions, tri_rows, tri_valid, csr: CornerCSR):
    """Plain twin of ``tri_curvature_data``: (cot, va, k_vecs, vertex_areas)."""
    cot, k0, k1, k2, va, _area = dgeo.curvature_corners(*_corners(positions, tri_rows), tri_valid)
    k_vecs = vs.reference(torch.stack([k0, k1, k2], dim=1), csr)
    return cot, va, k_vecs, vs.reference(va, csr)


def curvature_data_vjp_reference(positions, tri_rows, tri_valid, csr: CornerCSR, g_kvecs,
                                 g_varea, g_cot, g_va):
    """Plain twin of ``tri_curvature_data_bwd``: the corner upstream, autograd, the vertex sum."""
    T = tri_rows.shape[0]
    zeros = positions.new_zeros((T, 3))
    g_k = zeros[:, :, None].expand(T, 3, 3) if g_kvecs is None else g_kvecs[tri_rows]
    g_va_c = zeros if g_va is None else g_va
    if g_varea is not None:
        g_va_c = g_va_c + g_varea[tri_rows]
    dc = curvature_corners_vjp(positions, tri_rows, tri_valid, zeros if g_cot is None else g_cot,
                               g_k, g_va_c, zeros[:, 0])
    return vs.reference(dc, csr)


def _surface(positions, tri_rows, tri_valid, tension, csr, ws, grad):
    if positions.is_cuda:
        if ws is None:
            ws = Workspace(tri_rows.shape[0], positions.dtype, positions.device)
        e, dpos = launch_surface_energy(positions.contiguous(), tri_rows, tri_valid,
                                        tension.contiguous(), csr, ws, grad)
        return e.reshape(()), dpos
    return surface_energy_reference(positions, tri_rows, tri_valid, tension, csr, grad)


# --- the member axis: twins (each member's twin, the CPU path and the
# oracle), Functions over a leading member axis, and the vmap rules that
# reach them ------------------------------------------------------------
def surface_energy_members_reference(positions, tri_rows, tri_valid, tension, csr: CornerCSR,
                                     grad: bool):
    """Plain twin of ``tri_surface_energy_members``: :func:`surface_energy_reference` per member."""
    tensions = tension if tension.dim() == 2 else [tension] * positions.shape[0]
    out = [surface_energy_reference(x, tri_rows, tri_valid, t, csr, grad)
           for x, t in zip(positions, tensions)]
    e = torch.stack([o[0] for o in out])
    return e, torch.stack([o[1] for o in out]) if grad else None


def curvature_data_members_reference(positions, tri_rows, tri_valid, csr: CornerCSR):
    """Plain twin of ``tri_curvature_data_members``: :func:`curvature_data_reference` per member."""
    out = [curvature_data_reference(x, tri_rows, tri_valid, csr) for x in positions]
    return tuple(torch.stack(parts) for parts in zip(*out))


def curvature_data_vjp_members_reference(positions, tri_rows, tri_valid, csr: CornerCSR, g_kvecs,
                                         g_varea, g_cot, g_va):
    """Plain twin of ``tri_curvature_data_bwd_members``, per member."""
    def part(g, m):
        return None if g is None else g[m]

    return torch.stack([
        curvature_data_vjp_reference(x, tri_rows, tri_valid, csr, part(g_kvecs, m),
                                     part(g_varea, m), part(g_cot, m), part(g_va, m))
        for m, x in enumerate(positions)])


def p1_divergence_members_reference(positions, tilts, tri_rows, tri_valid):
    """Plain twin of ``tri_p1_div_members``: ``tilt_ops.p1_triangle_divergence`` per member."""
    out = [tilt_ops.p1_triangle_divergence(x, t, tri_rows, tri_valid)
           for x, t in zip(positions, tilts)]
    return tuple(torch.stack(parts) for parts in zip(*out))


def p1_div_vjp_members_reference(g, tri_valid, g_div, csr: CornerCSR):
    """Plain twin of ``tri_p1_div_bwd_members``: :func:`p1_div_vjp_reference` per member."""
    return torch.stack([p1_div_vjp_reference(gm, tri_valid, dm, csr)
                        for gm, dm in zip(g, g_div)])


def _surface_members(positions, tri_rows, tri_valid, tension, csr, ws, grad):
    if positions.is_cuda:
        if ws is None:
            ws = MemberWorkspace(positions.shape[0], tri_rows.shape[0], positions.dtype,
                                 positions.device)
        return launch_surface_energy_members(positions.contiguous(), tri_rows, tri_valid,
                                             tension.contiguous(), csr, ws, grad)
    return surface_energy_members_reference(positions, tri_rows, tri_valid, tension, csr, grad)


def _member_dim(in_dims, batch_size, x, index: int):
    """``x`` with its member axis first: moved there, or (shared input) expanded to it."""
    if in_dims[index] is None:
        return x.expand((batch_size,) + tuple(x.shape))
    return x.movedim(in_dims[index], 0)


def _shared(in_dims, **indices) -> None:
    """Raise when an input the member-axis launches share carries the member axis."""
    for name, index in indices.items():
        if in_dims[index] is not None:
            raise NotImplementedError(
                f"the member-axis tri kernels share {name} across members; it varies here")


class _MemberSurfaceEnergy(torch.autograd.Function):
    """:class:`_SurfaceEnergy` over a leading member axis (its ``vmap`` rule's launch)."""

    @staticmethod
    def forward(ctx, positions, tri_rows, tri_valid, tension, csr, ws):
        e, dpos = _surface_members(positions.detach(), tri_rows, tri_valid, tension, csr, ws,
                                   True)
        ctx.save_for_backward(dpos)
        return e

    @staticmethod
    def backward(ctx, ct):
        (dpos,) = ctx.saved_tensors
        return ct[:, None, None] * dpos, None, None, None, None, None


class _SurfaceEnergy(torch.autograd.Function):
    @staticmethod
    def forward(positions, tri_rows, tri_valid, tension, csr, ws):
        return _surface(positions.detach(), tri_rows, tri_valid, tension, csr, ws, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _e, dpos = output
        ctx.mark_non_differentiable(dpos)
        ctx.save_for_backward(dpos)

    @staticmethod
    def backward(ctx, ct, _ct_dpos):
        (dpos,) = ctx.saved_tensors
        return ct * dpos, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, positions, tri_rows, tri_valid, tension, csr, ws):
        """All members in one launch; the gradient only where autograd follows the positions."""
        _shared(in_dims, tri_rows=1, tri_valid=2)
        x = _member_dim(in_dims, info.batch_size, positions, 0)
        if in_dims[3] is not None:
            tension = tension.movedim(in_dims[3], 0)
        ws = None if ws is None or ws.topo is None else member_workspace(ws.topo, x)
        if torch.is_grad_enabled() and x.requires_grad:
            return (_MemberSurfaceEnergy.apply(x, tri_rows, tri_valid, tension, csr, ws),
                    None), (0, None)
        e, _dpos = _surface_members(x, tri_rows, tri_valid, tension, csr, ws, False)
        return (e, None), (0, None)


class _Curvature(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, tri_rows, tri_valid, csr):
        if positions.is_cuda:
            cot, k, va, area = launch_curvature(positions.contiguous(), tri_rows, tri_valid)
        else:
            cot, k0, k1, k2, va, area = dgeo.curvature_corners(
                *_corners(positions, tri_rows), tri_valid
            )
            k = torch.stack([k0, k1, k2], dim=1)
        ctx.save_for_backward(positions, tri_rows, tri_valid)
        ctx.csr = csr
        return cot, k, va, area

    @staticmethod
    def backward(ctx, g_cot, g_k, g_va, g_area):
        positions, tri_rows, tri_valid = ctx.saved_tensors
        upstream = [x.contiguous() for x in (g_cot, g_k, g_va, g_area)]
        if positions.is_cuda:
            dc = launch_curvature_bwd(positions.contiguous(), tri_rows, tri_valid, *upstream)
            return vs.launch(dc, ctx.csr), None, None, None
        dc = curvature_corners_vjp(positions, tri_rows, tri_valid, *upstream)
        return vs.reference(dc, ctx.csr), None, None, None


def _curvature_data_members(positions, tri_rows, tri_valid, csr):
    if positions.is_cuda:
        return launch_curvature_data_members(positions.contiguous(), tri_rows, tri_valid, csr)
    return curvature_data_members_reference(positions, tri_rows, tri_valid, csr)


class _MemberCurvatureData(torch.autograd.Function):
    """:class:`_CurvatureData` over a leading member axis (its ``vmap`` rule's launches)."""

    @staticmethod
    def forward(ctx, positions, tri_rows, tri_valid, csr):
        ctx.set_materialize_grads(False)
        cot, va, k_vecs, vertex_areas = _curvature_data_members(positions, tri_rows, tri_valid,
                                                                csr)
        ctx.save_for_backward(positions, tri_rows, tri_valid)
        ctx.csr = csr
        return k_vecs, vertex_areas, cot, va

    @staticmethod
    def backward(ctx, g_kvecs, g_varea, g_cot, g_va):
        upstream = [None if g is None else g.contiguous() for g in (g_kvecs, g_varea, g_cot, g_va)]
        if all(g is None for g in upstream):
            return None, None, None, None
        positions, tri_rows, tri_valid = ctx.saved_tensors
        if positions.is_cuda:
            dpos = launch_curvature_data_bwd_members(positions.contiguous(), tri_rows, tri_valid,
                                                     ctx.csr, *upstream)
        else:
            dpos = curvature_data_vjp_members_reference(positions, tri_rows, tri_valid, ctx.csr,
                                                        *upstream)
        return dpos, None, None, None


class _CurvatureData(torch.autograd.Function):
    @staticmethod
    def forward(positions, tri_rows, tri_valid, csr):
        if positions.is_cuda:
            cot, va, k_vecs, vertex_areas = launch_curvature_data(
                positions.contiguous(), tri_rows, tri_valid, csr)
        else:
            cot, va, k_vecs, vertex_areas = curvature_data_reference(
                positions, tri_rows, tri_valid, csr)
        return k_vecs, vertex_areas, cot, va

    @staticmethod
    def setup_context(ctx, inputs, output):
        positions, tri_rows, tri_valid, csr = inputs
        ctx.set_materialize_grads(False)  # an unused output passes None: no zeros are made
        ctx.save_for_backward(positions, tri_rows, tri_valid)
        ctx.csr = csr

    @staticmethod
    def backward(ctx, g_kvecs, g_varea, g_cot, g_va):
        upstream = [None if g is None else g.contiguous() for g in (g_kvecs, g_varea, g_cot, g_va)]
        if all(g is None for g in upstream):
            return None, None, None, None
        positions, tri_rows, tri_valid = ctx.saved_tensors
        if positions.is_cuda:
            dpos = launch_curvature_data_bwd(positions.contiguous(), tri_rows, tri_valid, ctx.csr,
                                             *upstream)
        else:
            dpos = curvature_data_vjp_reference(positions, tri_rows, tri_valid, ctx.csr, *upstream)
        return dpos, None, None, None

    @staticmethod
    def vmap(info, in_dims, positions, tri_rows, tri_valid, csr):
        """All members in one launch each way."""
        _shared(in_dims, tri_rows=1, tri_valid=2)
        x = _member_dim(in_dims, info.batch_size, positions, 0)
        return _MemberCurvatureData.apply(x, tri_rows, tri_valid, csr), (0, 0, 0, 0)


def _p1_divergence_members(positions, tilts, tri_rows, tri_valid):
    if positions.is_cuda:
        return launch_p1_divergence_members(positions.contiguous(), tilts.contiguous(), tri_rows,
                                            tri_valid)
    return p1_divergence_members_reference(positions, tilts, tri_rows, tri_valid)


class _MemberP1Divergence(torch.autograd.Function):
    """:class:`_P1Divergence` over a leading member axis (its ``vmap`` rule's launches)."""

    @staticmethod
    def forward(ctx, positions, tilts, tri_rows, tri_valid, csr):
        ctx.set_materialize_grads(False)
        div, area, g = _p1_divergence_members(positions, tilts, tri_rows, tri_valid)
        ctx.save_for_backward(g, tri_valid)
        ctx.csr = csr
        ctx.mark_non_differentiable(area, g)
        return div, area, g

    @staticmethod
    def backward(ctx, grad_div, _grad_area, _grad_g):
        if grad_div is None:
            return None, None, None, None, None
        g, tri_valid = ctx.saved_tensors
        if g.is_cuda:
            dtilts = launch_p1_div_bwd_members(g, tri_valid, grad_div.contiguous(), ctx.csr)
        else:
            dtilts = p1_div_vjp_members_reference(g, tri_valid, grad_div, ctx.csr)
        return None, dtilts, None, None, None


class _P1Divergence(torch.autograd.Function):
    @staticmethod
    def forward(positions, tilts, tri_rows, tri_valid, csr):
        if positions.is_cuda:
            return launch_p1_divergence(positions.contiguous(), tilts.contiguous(), tri_rows,
                                        tri_valid)
        return tilt_ops.p1_triangle_divergence(positions, tilts, tri_rows, tri_valid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _positions, _tilts, _tri_rows, tri_valid, csr = inputs
        _div, area, g = output
        ctx.set_materialize_grads(False)  # no upstream of div: no launch
        ctx.save_for_backward(g, tri_valid)
        ctx.csr = csr
        ctx.mark_non_differentiable(area, g)

    @staticmethod
    def backward(ctx, grad_div, _grad_area, _grad_g):
        if grad_div is None:
            return None, None, None, None, None
        g, tri_valid = ctx.saved_tensors
        if g.is_cuda:
            dtilts = launch_p1_div_bwd(g, tri_valid, grad_div.contiguous(), ctx.csr)
        else:
            dtilts = p1_div_vjp_reference(g, tri_valid, grad_div, ctx.csr)
        return None, dtilts, None, None, None

    @staticmethod
    def vmap(info, in_dims, positions, tilts, tri_rows, tri_valid, csr):
        """All members in one launch each way (the positions or the tilts may be shared)."""
        _shared(in_dims, tri_rows=2, tri_valid=3)
        x = _member_dim(in_dims, info.batch_size, positions, 0)
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError("p1_triangle_divergence takes frozen positions; detach them first")
        t = _member_dim(in_dims, info.batch_size, tilts, 1)
        return _MemberP1Divergence.apply(x, t, tri_rows, tri_valid, csr), (0, 0, 0)


# ----------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------
def surface_energy(positions, tri_rows, tri_valid, tension, csr: CornerCSR, ws=None):
    """Scalar surface energy ``sum_t [valid_t] tension_t A_t``, differentiable in ``positions``.

    When autograd needs the position gradient, one call computes the energy
    and the vertex gradient (summed in the order of ``csr``, the topology's
    corner CSR) and the backward scales it; otherwise the call computes the
    energy alone.  ``ws`` is the topology's :class:`Workspace` for the CUDA
    path (:func:`workspace`; made per call when None).
    """
    if vs.batched(positions):
        return _SurfaceEnergy.apply(positions, tri_rows, tri_valid, tension, csr, ws)[0]
    if torch.is_grad_enabled() and positions.requires_grad:
        return _SurfaceEnergy.apply(positions, tri_rows, tri_valid, tension, csr, ws)[0]
    e, _dpos = _surface(positions, tri_rows, tri_valid, tension, csr, ws, False)
    return e


def surface_energy_and_gradient(positions, tri_rows, tri_valid, tension, csr: CornerCSR, ws=None):
    """(energy 0-dim, dE/dpositions (Nv, 3)) of :func:`surface_energy` from one call, no graph.

    For the area constraints, which take the total area and its gradient
    (unit tension on the triangles they hold) at every projection step.
    """
    return _surface(positions.detach(), tri_rows, tri_valid, tension, csr, ws, True)


def curvature_corners(positions, tri_rows, tri_valid, csr: CornerCSR):
    """(cot, k0, k1, k2, va, tri_areas) of ``geo.curvature_corners``, differentiable.

    The backward's corner gradients go to the vertices through the vertex
    sum over ``csr``, the corner CSR of ``tri_rows``.
    """
    cot, k, va, area = _Curvature.apply(positions, tri_rows, tri_valid, csr)
    return cot, k[:, 0], k[:, 1], k[:, 2], va, area


def curvature_data(positions, tri_rows, tri_valid, csr: CornerCSR) -> dgeo.CurvatureData:
    """``geo.curvature_data``, differentiable in ``positions``, one kernel call each way.

    ``csr`` is the corner CSR of ``tri_rows`` (``Topology.corner_csr()``);
    the vertex sums follow its order, so repeated calls give the same bits.
    """
    k_vecs, vertex_areas, cot, va = _CurvatureData.apply(positions, tri_rows, tri_valid, csr)
    return dgeo.CurvatureData(k_vecs=k_vecs, vertex_areas=vertex_areas, weights=cot,
                              corner_areas=va)


def p1_triangle_divergence(positions, tilts, tri_rows, tri_valid, csr: CornerCSR):
    """``tilt_ops.p1_triangle_divergence`` at frozen positions: (div, area, g (T, 3, 3)).

    One kernel call forward (masks included), one backward in the tilts
    (the weighted vertex sum over ``csr``, the corner CSR of ``tri_rows``).
    Differentiable in ``tilts`` only: a call whose positions require grad
    raises instead of dropping their gradient.
    """
    if positions.requires_grad and torch.is_grad_enabled():
        raise ValueError("p1_triangle_divergence takes frozen positions; detach them first")

    return _P1Divergence.apply(positions, tilts, tri_rows, tri_valid, csr)
