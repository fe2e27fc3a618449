"""Helfrich / Willmore bending energy on the cotan Laplacian.

Counterpart of ``membrane_solver_tpu/energy/bending.py``:

    H_v      = |K_v| / (2 * max(A_vor_v, 1e-12))
    helfrich: E = 0.5 * sum_v kappa_v (2 H_v - c0_v)^2 A_eff_v
    willmore: E = sum_v kappa_v H_v^2 A_eff_v

with the curvature term zeroed on boundary vertices and effective areas
A_eff that redistribute the boundary corners' mixed-area contributions
equally to the interior corners of each triangle.  Per-vertex
``bending_modulus`` and ``spontaneous_curvature`` / ``intrinsic_curvature``
options compile to dense tables.  The gradient is autograd through this
energy; the per-triangle curvature terms and their backward are the
``tri_kernels`` curvature kernels on the card (``tri_kernels.curvature_data``).
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.reduce import member_sum
from membrane_solver_tpu_torch.energy import param
from membrane_solver_tpu_torch.kernels import tri_kernels

USES_TILT = False
USES_TILT_LEAFLETS = False
# compile_topology's tables with one row per vertex
VERTEX_TABLES = ("has_kappa", "kappa", "has_c0", "c0")


def compile_topology(layout) -> dict:
    """Per-vertex kappa / c0 override tables (exact size, in row order)."""
    n = layout.n_vertices
    has_kappa = np.zeros(n, dtype=bool)
    kappa = np.zeros(n)
    has_c0 = np.zeros(n, dtype=bool)
    c0 = np.zeros(n)
    for vid, vertex in layout.mesh.vertices.items():
        row = layout.row_of[int(vid)]
        opts = vertex.options or {}
        if "bending_modulus" in opts:
            try:
                kappa[row] = float(opts["bending_modulus"])
                has_kappa[row] = True
            except (TypeError, ValueError):
                pass
        c0_val = opts.get("spontaneous_curvature", opts.get("intrinsic_curvature"))
        if c0_val is not None:
            try:
                c0[row] = float(c0_val)
                has_c0[row] = True
            except (TypeError, ValueError):
                pass
    return {"has_kappa": has_kappa, "kappa": kappa, "has_c0": has_c0, "c0": c0}


def effective_vertex_areas(curv: dgeo.CurvatureData, topo) -> torch.Tensor:
    """Mixed-Voronoi areas with boundary corners redistributed to interior ones."""
    va = curv.corner_areas
    tri_is_b = topo.boundary_vertex_mask[topo.tri_rows]
    interior = ~tri_is_b
    n_interior = torch.sum(interior, dim=1)
    redistribute = (n_interior > 0) & torch.any(tri_is_b, dim=1)
    b_sum = torch.sum(torch.where(tri_is_b, va, 0.0), dim=1)
    extra = torch.where(redistribute, b_sum / torch.clamp(n_interior, min=1), 0.0)
    va_eff = torch.where(
        redistribute[:, None], torch.where(interior, va + extra[:, None], 0.0), va
    )
    return dgeo.scatter_add_rows(va_eff[:, 0], va_eff[:, 1], va_eff[:, 2], topo.corner_csr())


def bending_fields(state, topo):
    """(H, curvature data, A_eff, interior mask)."""
    positions = state.positions
    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    vnormals = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())
    curv = tri_kernels.curvature_data(positions, topo.tri_rows, topo.tri_valid, topo.corner_csr())
    safe_vor = torch.clamp(curv.vertex_areas, min=1e-12)
    # |K| with the normal-direction gradient fallback at flat states
    H = dgeo.directional_norm(curv.k_vecs, vnormals) / (2.0 * safe_vor)
    a_eff = effective_vertex_areas(curv, topo)
    interior = topo.vertex_valid & ~topo.boundary_vertex_mask
    return H, curv, a_eff, interior


def make_energy(spec):
    """Specialize on the static bending_energy_model global parameter."""
    model = spec.option("bending_energy_model", "helfrich").lower()
    model = "helfrich" if model == "helfrich" else "willmore"

    def fn(geo, state, topo, params):
        return energy(geo, state, topo, params, model=model)

    return fn


def energy(geo, state, topo, params, model: str = "helfrich"):
    positions = state.positions
    ex = topo.extras
    kappa = torch.where(
        ex["energy:bending/has_kappa"], ex["energy:bending/kappa"],
        param(params, "bending_modulus", like=positions),
    )
    c0 = torch.where(
        ex["energy:bending/has_c0"], ex["energy:bending/c0"],
        param(params, "spontaneous_curvature", "intrinsic_curvature", like=positions),
    )
    H, _curv, a_eff, interior = bending_fields(state, topo)
    if model == "helfrich":
        term = torch.where(interior, 2.0 * H - c0, 0.0)
        density = 0.5 * kappa * term**2
    else:
        H_eff = torch.where(interior, H, 0.0)
        density = kappa * H_eff**2
    return member_sum(torch.where(topo.vertex_valid, density * a_eff, 0.0))
