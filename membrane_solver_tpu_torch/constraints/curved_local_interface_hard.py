"""Ring-averaged hard constraint on the local shell family near r = R.

Counterpart of ``membrane_solver_tpu/constraints/curved_local_interface_hard.py``:

- one KKT tilt row on the outer leaflet: r_dir / n_valid at each matched
  rim row, r_dir the rim radial direction tangent-projected against the
  live vertex normals (``geo.vertex_normals``, summed by the vertex-sum
  kernel on the card);
- ``make_enforce_tilts``: the mean residual mean(t_out . r_dir - phi),
  phi = (z_outer - z_rim) / (r_outer - r_rim), subtracted along r_dir
  from every free participating rim row.

The pairs are the (``rim_rows_matched``, ``outer_rows``) of
``local_interface_shells``, resolved when the problem is compiled; a rim
row repeats where the rim and outer shells differ in size, and its values
are then added one after the other (``state.ordered_index_add``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.constraints.local_interface_shells import (
    build_shell_rows,
    pack_pairs,
)
from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.reduce import tree_sum
from membrane_solver_tpu_torch.device.state import ordered_index_add
from membrane_solver_tpu_torch.energy._local_interface import radial_hat

_PREFIX = "constraint:curved_local_interface_hard"


def compile_topology(layout) -> dict:
    shells = build_shell_rows(layout)
    if shells is None:
        return pack_pairs(layout, np.zeros(0, dtype=int), np.zeros(0, dtype=int))
    return pack_pairs(layout, shells.rim_rows_matched, shells.outer_rows)


def _matching(positions, topo):
    """(rim rows, r_dir, phi, ok) from the live positions."""
    x = lambda k: topo.extras[f"{_PREFIX}/{k}"]  # noqa: E731
    rim_rows = x("rows_a")
    outer_rows = x("rows_b")
    valid = x("valid")
    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    normals = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())

    r_rim, r_hat = radial_hat(positions, rim_rows)
    n_rim = normals[rim_rows]
    r_dir = r_hat - torch.sum(r_hat * n_rim, dim=1, keepdim=True) * n_rim
    rnorm = torch.linalg.vector_norm(r_dir, dim=1)
    ok = valid & (rnorm > 1e-12)
    r_dir = torch.where(ok[:, None], r_dir / torch.clamp(rnorm, min=1e-12)[:, None], 0.0)

    r_out = torch.linalg.vector_norm(positions[outer_rows, :2], dim=1)
    dr = r_out - r_rim
    ok = ok & (torch.abs(dr) > 1e-12)
    phi = torch.where(
        ok, (positions[outer_rows, 2] - positions[rim_rows, 2]) / torch.where(ok, dr, 1.0), 0.0
    )
    return rim_rows, r_dir, phi, ok


def ordered_rows(topo) -> dict:
    """{key: rows} of this module's ``ordered_index_add`` calls (the parameter sweep builds
    their levels before it maps the members)."""
    if f"{_PREFIX}/rows_a" not in topo.extras:
        return {}
    return {_PREFIX + "/rows_a": topo.extras[f"{_PREFIX}/rows_a"]}


def make_tilt_constraint_rows(spec):
    def fn(state, topo, params):
        if f"{_PREFIX}/rows_a" not in topo.extras:
            return None
        positions = state.positions
        rim_rows, r_dir, _phi, ok = _matching(positions, topo)
        n_valid = torch.clamp(tree_sum(ok.to(positions.dtype)), min=1.0)
        zeros = positions.new_zeros((positions.shape[0], 3))
        gout = ordered_index_add(topo, _PREFIX + "/rows_a", zeros, rim_rows,
                                 torch.where(ok[:, None], r_dir / n_valid, 0.0))
        return torch.stack([zeros, gout], dim=0)[None]  # (1, 2=in/out, Nv, 3)

    return fn


def make_enforce_tilts(spec):
    def enforce(state, topo, params):
        if f"{_PREFIX}/rows_a" not in topo.extras:
            return state
        positions = state.positions
        rim_rows, r_dir, phi, ok = _matching(positions, topo)
        ok = ok & ~topo.tilt_fixed_out_mask[rim_rows]
        t_out = state.tilts_out
        residual = torch.where(ok, torch.sum(t_out[rim_rows] * r_dir, dim=1) - phi, 0.0)
        n_valid = torch.clamp(tree_sum(ok.to(positions.dtype)), min=1.0)
        mean_res = tree_sum(residual) / n_valid
        delta = torch.where(ok[:, None], -mean_res * r_dir, 0.0)
        return dataclasses.replace(
            state, tilts_out=ordered_index_add(topo, _PREFIX + "/rows_a", t_out, rim_rows, delta))

    return enforce
