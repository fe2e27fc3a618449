"""Per-triangle geometry kernels: CUDA wrappers, autograd Functions, dispatch.

Counterpart of ``membrane_solver_tpu/pallas_kernels/tri_kernels.py``.  Four
kernels in ``csrc/tri_kernels.cu``, each for float32 and float64, compiled
with ``nvcc`` for ``sm_90a`` at first use (``kernels/_build``) and bound
with ``ctypes``:

- ``surface_fwd``: per-triangle surface energy ``gamma * A`` and its corner
  gradients (twin: ``geo.surface_corner_terms``);
- ``curvature_fwd``: cotan weights, corner mean-curvature vectors, Meyer
  corner areas and triangle areas (twin: ``geo.curvature_corners``);
- ``curvature_bwd``: the vector-Jacobian product of ``curvature_fwd`` with
  respect to the corner positions (twin: autograd of
  ``geo.curvature_corners``);
- ``p1_div_fwd``: P1 shape gradients, tilt divergence and area (twin:
  ``tilt_ops.p1_divergence_corners``).

Each kernel gathers its corners through ``tri_rows`` itself; the scatter of
corner gradients back to vertex rows is an ``index_add`` here.

Dispatch: the public functions (:func:`surface_energies`,
:func:`curvature_corners` and :func:`curvature_data`, :func:`p1_divergence`
and :func:`p1_triangle_divergence`) are autograd-aware, and the energy
modules call them in place of the plain ``geo`` / ``tilt_ops`` functions.  A
CUDA tensor launches the kernels, after device, dtype, shape and
contiguity checks that raise on anything else; a CPU tensor runs the
twins.  The backward passes are the same code on both devices apart from
the curvature backward, which is the ``curvature_bwd`` kernel on the card
and autograd of the twin on the CPU.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device import tilt_ops
from membrane_solver_tpu_torch.kernels import _build

LAUNCHES = {"surface_fwd": 0, "curvature_fwd": 0, "curvature_bwd": 0, "p1_div_fwd": 0}

# -fmad=false: no contracted multiply-adds, so the obtuse-branch tests see
# the twin's rounding (see the note in the source)
KERNEL = _build.Source("tri_kernels", extra_flags=("-fmad=false",))
SOURCE = KERNEL.path

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
        "tri_curvature_fwd": [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr],
        "tri_curvature_bwd": [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr],
        "tri_p1_div_fwd": [i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
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
    if T >= 2**31:
        raise ValueError(f"{T} triangles exceed the kernel's int index")
    _check(positions, positions.dtype,
           positions=(positions, positions.shape, None), tri_rows=(tri_rows, (T, 3), torch.int64))
    return T


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {code}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_surface(positions, tri_rows, gamma):
    """(e (T,), g (T, 3, 3)) from the ``surface_fwd`` kernel."""
    T = _check_rows(positions, tri_rows)
    _check(positions, positions.dtype, gamma=(gamma, (T,), None))
    lib = build()
    e = torch.empty(T, dtype=positions.dtype, device=positions.device)
    g = torch.empty((T, 3, 3), dtype=positions.dtype, device=positions.device)
    code = lib.tri_surface_fwd(
        int(positions.dtype == torch.float64), positions.data_ptr(), tri_rows.data_ptr(),
        gamma.data_ptr(), e.data_ptr(), g.data_ptr(), T, positions.shape[0], _stream(positions),
    )
    _raise_on(code, "tri_surface_fwd")
    LAUNCHES["surface_fwd"] += 1
    return e, g


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


def launch_p1_div(positions, tilts, tri_rows):
    """(div (T,), area (T,), g (T, 3, 3)) from the ``p1_div_fwd`` kernel."""
    T = _check_rows(positions, tri_rows)
    _check(positions, positions.dtype, tilts=(tilts, positions.shape, None))
    lib = build()
    kw = {"dtype": positions.dtype, "device": positions.device}
    div, area, g = (torch.empty(s, **kw) for s in ((T,), (T,), (T, 3, 3)))
    code = lib.tri_p1_div_fwd(
        int(positions.dtype == torch.float64), positions.data_ptr(), tilts.data_ptr(),
        tri_rows.data_ptr(), div.data_ptr(), area.data_ptr(), g.data_ptr(),
        T, positions.shape[0], _stream(positions),
    )
    _raise_on(code, "tri_p1_div_fwd")
    LAUNCHES["p1_div_fwd"] += 1
    return div, area, g


# ----------------------------------------------------------------------
# autograd Functions (kernels on the card, twins on the CPU)
# ----------------------------------------------------------------------
def _corners(x, tri_rows):
    return x[tri_rows[:, 0]], x[tri_rows[:, 1]], x[tri_rows[:, 2]]


def _scatter_corners(dc, tri_rows, n_rows):
    """Sum (T, 3, 3) corner rows into (n_rows, 3) vertex rows."""
    return dgeo.scatter_add_rows(dc[:, 0], dc[:, 1], dc[:, 2], tri_rows, n_rows)


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


class _Surface(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, tri_rows, gamma):
        if positions.is_cuda:
            e, g = launch_surface(positions.contiguous(), tri_rows, gamma.contiguous())
        else:
            e, g0, g1, g2 = dgeo.surface_corner_terms(*_corners(positions, tri_rows), gamma)
            g = torch.stack([g0, g1, g2], dim=1)
        ctx.save_for_backward(g, tri_rows)
        ctx.n_rows = positions.shape[0]
        ctx.mark_non_differentiable(g)
        return e, g

    @staticmethod
    def backward(ctx, grad_e, _grad_g):
        g, tri_rows = ctx.saved_tensors
        return _scatter_corners(grad_e[:, None, None] * g, tri_rows, ctx.n_rows), None, None


class _Curvature(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, tri_rows, tri_valid):
        if positions.is_cuda:
            cot, k, va, area = launch_curvature(positions.contiguous(), tri_rows, tri_valid)
        else:
            cot, k0, k1, k2, va, area = dgeo.curvature_corners(
                *_corners(positions, tri_rows), tri_valid
            )
            k = torch.stack([k0, k1, k2], dim=1)
        ctx.save_for_backward(positions, tri_rows, tri_valid)
        return cot, k, va, area

    @staticmethod
    def backward(ctx, g_cot, g_k, g_va, g_area):
        positions, tri_rows, tri_valid = ctx.saved_tensors
        upstream = [x.contiguous() for x in (g_cot, g_k, g_va, g_area)]
        if positions.is_cuda:
            dc = launch_curvature_bwd(positions.contiguous(), tri_rows, tri_valid, *upstream)
        else:
            dc = curvature_corners_vjp(positions, tri_rows, tri_valid, *upstream)
        return _scatter_corners(dc, tri_rows, positions.shape[0]), None, None


class _P1Divergence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, tilts, tri_rows):
        if positions.is_cuda:
            div, area, g = launch_p1_div(positions.contiguous(), tilts.contiguous(), tri_rows)
        else:
            div, area, g0, g1, g2 = tilt_ops.p1_divergence_corners(
                *_corners(positions, tri_rows), *_corners(tilts, tri_rows)
            )
            g = torch.stack([g0, g1, g2], dim=1)
        ctx.save_for_backward(g, tri_rows)
        ctx.n_rows = tilts.shape[0]
        ctx.mark_non_differentiable(area, g)
        return div, area, g

    @staticmethod
    def backward(ctx, grad_div, _grad_area, _grad_g):
        g, tri_rows = ctx.saved_tensors
        return None, _scatter_corners(grad_div[:, None, None] * g, tri_rows, ctx.n_rows), None


# ----------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------
def surface_energies(positions, tri_rows, gamma):
    """Surface energy per triangle (T,), ``gamma * A``, differentiable in ``positions``.

    ``gamma`` (T,) is the per-triangle tension, zero on triangles that must
    not count.  The backward scales the corner gradients the forward saved.
    """
    e, _g = _Surface.apply(positions, tri_rows, gamma)
    return e


def curvature_corners(positions, tri_rows, tri_valid):
    """(cot, k0, k1, k2, va, tri_areas) of ``geo.curvature_corners``, differentiable."""
    cot, k, va, area = _Curvature.apply(positions, tri_rows, tri_valid)
    return cot, k[:, 0], k[:, 1], k[:, 2], va, area


def curvature_data(positions, tri_rows, tri_valid, n_rows) -> dgeo.CurvatureData:
    """``geo.curvature_data`` with its per-triangle terms from :func:`curvature_corners`."""
    cot, k0, k1, k2, va, _area = curvature_corners(positions, tri_rows, tri_valid)
    return dgeo.scatter_curvature(cot, k0, k1, k2, va, tri_rows, n_rows)


def p1_divergence(positions, tilts, tri_rows):
    """(div, area, g0, g1, g2) of ``tilt_ops.p1_divergence_corners`` at frozen positions.

    Differentiable in ``tilts`` only: a call whose positions require grad
    raises instead of dropping their gradient.
    """
    if positions.requires_grad and torch.is_grad_enabled():
        raise ValueError("p1_divergence takes frozen positions; detach them first")
    div, area, g = _P1Divergence.apply(positions, tilts, tri_rows)
    return div, area, g[:, 0], g[:, 1], g[:, 2]


def p1_triangle_divergence(positions, tilts, tri_rows, tri_valid):
    """``tilt_ops.p1_triangle_divergence`` at frozen positions, from :func:`p1_divergence`."""
    return tilt_ops.mask_divergence(*p1_divergence(positions, tilts, tri_rows), tri_valid)
