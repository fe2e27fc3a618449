"""Tilt-only vector matching across the curved disk boundary.

Counterpart of ``membrane_solver_tpu/constraints/curved_local_interface_match.py``:

- each rim-shell row is paired with a disk-boundary row by azimuth
  (``local_mixed_match_v1`` pairs ``rim_rows_matched`` with the nearest
  disk rows);
- KKT tilt rows: per tangent-basis direction (u and v; v alone in the
  mixed mode) one aggregated row, +basis at every rim row and -basis at
  every disk row, once per leaflet;
- ``make_enforce_tilts``: per pair, both leaflet tilts projected in the
  pair-averaged tangent basis.  ``vector_average`` sets the (u, v)
  coefficients of both rows to their mean (``rim_to_disk`` /
  ``disk_to_rim``: to the named side's), a fixed side keeping its own;
  ``local_mixed_match_v1`` averages the v coefficient only and sets u to
  +phi (outer leaflet) or -phi (inner), phi the local slope of the
  (``rim_rows_matched``, ``outer_rows``) shells.

Pair normals, bases and phi are live; the pairs are resolved when the
problem is compiled.  A row repeats where the shells differ in size; its
values are then added one after the other (``state.ordered_index_add``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.constraints.local_interface_shells import (
    build_shell_rows,
    layout_positions,
    pack_pairs,
)
from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.state import ordered_index_add
from membrane_solver_tpu_torch.energy._local_interface import radial_hat

_PREFIX = "constraint:curved_local_interface_match"

_MODES = {
    "vector_average": "vector_average",
    "average": "vector_average",
    "local_mixed_match_v1": "local_mixed_match_v1",
    "mixed": "local_mixed_match_v1",
    "rim_to_disk": "rim_to_disk",
    "rim2disk": "rim_to_disk",
    "disk_to_rim": "disk_to_rim",
    "disk2rim": "disk_to_rim",
}


def _mode(gp) -> str:
    raw = gp.get("curved_local_interface_match_mode")
    return _MODES.get(str(raw or "vector_average").strip().lower(), "vector_average")


def compile_static(layout):
    return (_mode(layout.mesh.global_parameters),)


def compile_topology(layout) -> dict:
    shells = build_shell_rows(layout)
    if shells is None:
        empty = pack_pairs(layout, np.zeros(0, dtype=int), np.zeros(0, dtype=int))
        pairs = slope = empty
    else:
        if _mode(layout.mesh.global_parameters) == "local_mixed_match_v1":
            positions = layout_positions(layout)
            rim = shells.rim_rows_matched
            phi_rim = np.mod(np.arctan2(positions[rim, 1], positions[rim, 0]), 2 * np.pi)
            phi_disk = np.mod(np.arctan2(positions[shells.disk_rows, 1],
                                         positions[shells.disk_rows, 0]), 2 * np.pi)
            d = np.abs(phi_rim[:, None] - phi_disk[None, :])
            d = np.minimum(d, 2 * np.pi - d)
            disk = shells.disk_rows[np.argmin(d, axis=1)]
        else:
            rim = shells.rim_rows
            disk = shells.disk_rows_matched
        pairs = pack_pairs(layout, rim, disk)
        slope = pack_pairs(layout, shells.rim_rows_matched, shells.outer_rows)
    return {
        "pair_rows_a": pairs["rows_a"],  # rim rows
        "pair_rows_b": pairs["rows_b"],  # disk rows
        "pair_valid": pairs["valid"],
        "slope_rows_a": slope["rows_a"],
        "slope_rows_b": slope["rows_b"],
        "slope_valid": slope["valid"],
    }


def _unit(v, fallback=None):
    n = torch.linalg.vector_norm(v, dim=1)
    out = v / torch.clamp(n, min=1e-12)[:, None]
    return out if fallback is None else torch.where((n < 1e-12)[:, None], fallback, out)


def _bases(positions, topo):
    """(rim, disk, valid, u, v, phi): live pair tangent bases (u radial-preferred, v = n x u)."""
    x = lambda k: topo.extras[f"{_PREFIX}/{k}"]  # noqa: E731
    rim = x("pair_rows_a")
    disk = x("pair_rows_b")
    valid = x("pair_valid")
    dtype = positions.dtype
    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    normals = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())
    pair_n = normals[disk] + normals[rim]
    pn = torch.linalg.vector_norm(pair_n, dim=1)
    pair_n = torch.where((pn < 1e-12)[:, None], normals[rim], pair_n)
    pair_n = _unit(pair_n)

    _r_rim, r_hat = radial_hat(positions, rim)
    u = r_hat - torch.sum(r_hat * pair_n, dim=1, keepdim=True) * pair_n
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=positions.device)
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=positions.device)
    trial = torch.where((torch.abs(pair_n[:, 0]) > 0.9)[:, None], e_y, e_x)
    fallback = _unit(trial - torch.sum(trial * pair_n, dim=1, keepdim=True) * pair_n)
    u = _unit(u, fallback)
    v = _unit(torch.linalg.cross(pair_n, u), e_y.expand_as(u))

    # the local slope phi from the (rim_rows_matched, outer) shells
    s_rim = x("slope_rows_a")
    s_out = x("slope_rows_b")
    dr = torch.clamp(
        torch.linalg.vector_norm(positions[s_out, :2], dim=1)
        - torch.linalg.vector_norm(positions[s_rim, :2], dim=1),
        min=1e-6,
    )
    phi = (positions[s_out, 2] - positions[s_rim, 2]) / dr
    return rim, disk, valid, u, v, phi


def make_tilt_constraint_rows(spec):
    mode = spec.static_of(_PREFIX, ("vector_average",))[0]

    def fn(state, topo, params):
        if f"{_PREFIX}/pair_rows_a" not in topo.extras:
            return None
        positions = state.positions
        rim, disk, valid, u, v, _phi = _bases(positions, topo)
        rows_all = torch.cat([rim, disk])
        zeros = positions.new_zeros((positions.shape[0], 3))
        out = []
        for basis in ((v,) if mode == "local_mixed_match_v1" else (u, v)):
            vals = torch.where(valid[:, None], basis, 0.0)
            g = ordered_index_add(topo, _PREFIX + "/rim_disk", zeros, rows_all,
                                  torch.cat([vals, -vals]))
            out.append(torch.stack([g, zeros], dim=0))  # in-leaflet row
            out.append(torch.stack([zeros, g], dim=0))  # out-leaflet row
        return torch.stack(out, dim=0)

    return fn


def make_enforce_tilts(spec):
    mode = spec.static_of(_PREFIX, ("vector_average",))[0]

    def enforce(state, topo, params):
        if f"{_PREFIX}/pair_rows_a" not in topo.extras:
            return state
        rim, disk, valid, u, v, phi = _bases(state.positions, topo)

        def project(tilts, fixed_mask, radial_sign):
            d_fix = fixed_mask[disk]
            r_fix = fixed_mask[rim]
            cd_u = torch.sum(tilts[disk] * u, dim=1)
            cd_v = torch.sum(tilts[disk] * v, dim=1)
            cr_u = torch.sum(tilts[rim] * u, dim=1)
            cr_v = torch.sum(tilts[rim] * v, dim=1)
            if mode == "local_mixed_match_v1":
                tgt_v = 0.5 * (cd_v + cr_v)
                tgt_v = torch.where(d_fix, cd_v, tgt_v)
                tgt_v = torch.where(r_fix, cr_v, tgt_v)
                tgt_u_d = tgt_u_r = radial_sign * phi
            else:
                if mode == "disk_to_rim":
                    tgt_u, tgt_v = cd_u, cd_v
                elif mode == "rim_to_disk":
                    tgt_u, tgt_v = cr_u, cr_v
                else:
                    tgt_u = 0.5 * (cd_u + cr_u)
                    tgt_v = 0.5 * (cd_v + cr_v)
                tgt_u = torch.where(d_fix, cd_u, tgt_u)
                tgt_v = torch.where(d_fix, cd_v, tgt_v)
                tgt_u = torch.where(r_fix, cr_u, tgt_u)
                tgt_v = torch.where(r_fix, cr_v, tgt_v)
                tgt_u_d = tgt_u_r = tgt_u
            ok_d = valid & ~d_fix
            ok_r = valid & ~r_fix
            delta_d = torch.where(
                ok_d[:, None], (tgt_u_d - cd_u)[:, None] * u + (tgt_v - cd_v)[:, None] * v, 0.0)
            delta_r = torch.where(
                ok_r[:, None], (tgt_u_r - cr_u)[:, None] * u + (tgt_v - cr_v)[:, None] * v, 0.0)
            return ordered_index_add(topo, _PREFIX + "/disk_rim", tilts, torch.cat([disk, rim]),
                                     torch.cat([delta_d, delta_r]))

        tilts_in = project(state.tilts_in, topo.tilt_fixed_in_mask, -1.0)
        tilts_out = project(state.tilts_out, topo.tilt_fixed_out_mask, 1.0)
        return dataclasses.replace(state, tilts_in=tilts_in, tilts_out=tilts_out)

    return enforce
