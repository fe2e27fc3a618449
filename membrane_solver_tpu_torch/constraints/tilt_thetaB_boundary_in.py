"""Hard theta_B boundary condition on the inner-leaflet tilt: t_in . r_dir = thetaB.

Counterpart of ``membrane_solver_tpu/constraints/tilt_thetaB_boundary_in.py``:
r_dir is the in-plane radial direction about (``tilt_thetaB_center``,
``tilt_thetaB_normal`` or the fitted plane normal), tangent-projected
against the live vertex normals.  One KKT tilt row per free ring vertex on
the inner-leaflet block (compact, or dense beside a module whose rows have
no compact form); enforcement adds (thetaB - t_in.r_dir) r_dir on the free
rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.state import check_unique_rows
from membrane_solver_tpu_torch.energy import param

_PREFIX = "constraint:tilt_thetaB_boundary_in"


def compile_topology(layout) -> dict:
    mesh = layout.mesh
    gp = mesh.global_parameters
    empty = {
        "rows": np.zeros(1, dtype=np.int64),
        "valid": np.zeros(1, dtype=bool),
        "center": np.zeros(3),
        "normal": np.array([0.0, 0.0, 1.0]),
    }
    group = gp.get("tilt_thetaB_group_in")
    if group is None or not str(group).strip():
        return empty
    group = str(group).strip()
    rows = []
    for vid in sorted(mesh.vertices):
        opts = mesh.vertices[vid].options or {}
        if (
            opts.get("rim_slope_match_group") == group
            or opts.get("tilt_thetaB_group") == group
            or opts.get("tilt_thetaB_group_in") == group
        ):
            rows.append(layout.row_of[int(vid)])
    if not rows:
        return empty
    check_unique_rows(rows, "tilt_thetaB_boundary_in rows")  # the index_add of _apply
    center = np.asarray(gp.get("tilt_thetaB_center") or [0, 0, 0], dtype=float)
    raw_n = gp.get("tilt_thetaB_normal")
    if raw_n is not None:
        normal = np.asarray(raw_n, dtype=float).reshape(3)
        normal /= max(np.linalg.norm(normal), 1e-15)
    else:
        pos = np.array([mesh.vertices[int(layout.vertex_ids[r])].position for r in rows])
        centroid = pos.mean(axis=0)
        _, _, vh = np.linalg.svd(pos - centroid, full_matrices=False)
        normal = vh[-1]
    return {
        "rows": np.asarray(rows, dtype=np.int64),
        "valid": np.ones(len(rows), dtype=bool),
        "center": center,
        "normal": normal,
    }


def _directions(positions, topo):
    """(rows, r_dir, ok) for the free ring rows (tilt-fixed rows masked off)."""
    x = lambda k: topo.extras[f"{_PREFIX}/{k}"]  # noqa: E731
    rows = x("rows")
    valid = x("valid")
    dtype = positions.dtype
    center = x("center").to(dtype)
    normal = x("normal").to(dtype)
    pts = positions[rows]
    rel = pts - center
    rel_p = rel - torch.sum(rel * normal, dim=1, keepdim=True) * normal
    r_len = torch.linalg.vector_norm(rel_p, dim=1)
    good = valid & (r_len > 1e-12)
    r_hat = torch.where(good[:, None], rel_p / torch.clamp(r_len, min=1e-12)[:, None], 0.0)
    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    vnorm = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())[rows]
    r_dir = r_hat - torch.sum(r_hat * vnorm, dim=1, keepdim=True) * vnorm
    nrm = torch.linalg.vector_norm(r_dir, dim=1)
    ok = good & (nrm > 1e-12)
    r_dir = torch.where(ok[:, None], r_dir / torch.clamp(nrm, min=1e-12)[:, None], 0.0)
    return rows, r_dir, ok & ~topo.tilt_fixed_in_mask[rows]


def make_tilt_constraint_rows(spec):
    """Dense (k, 2, Nv, 3) (in, out) rows: r_dir at each free ring row on the inner block.

    The relax takes these when another module's rows have no compact form.
    """

    def fn(state, topo, params):
        positions = state.positions
        rows, r_dir, ok = _directions(positions, topo)
        k = rows.shape[0]
        idx = torch.arange(k, device=rows.device)
        gin = positions.new_zeros((k, positions.shape[0], 3)).index_put(
            (idx, rows), torch.where(ok[:, None], r_dir, 0.0), accumulate=True)
        return torch.stack([gin, torch.zeros_like(gin)], dim=1)

    return fn


def make_compact_tilt_rows(spec):
    """Compact form: values (k,1,3), rows (k,1), leaflet (k,1)=0 (inner)."""

    def fn(state, topo, params):
        rows, r_dir, ok = _directions(state.positions, topo)
        vals = torch.where(ok[:, None], r_dir, 0.0)[:, None, :]
        safe_rows = torch.where(ok, rows, 0)[:, None]
        return vals, safe_rows, torch.zeros_like(safe_rows)

    return fn


def _apply(tin, rows, r_dir, ok, params):
    theta = param(params, "tilt_thetaB_value", like=tin)
    t_rad = torch.sum(tin[rows] * r_dir, dim=1)
    delta = torch.where(ok, theta - t_rad, 0.0)
    return tin.index_add(0, rows, delta[:, None] * r_dir)


def make_enforce_tilts(spec):
    def enforce(state, topo, params):
        rows, r_dir, ok = _directions(state.positions, topo)
        return dataclasses.replace(
            state, tilts_in=_apply(state.tilts_in, rows, r_dir, ok, params)
        )

    return enforce


def make_frozen_enforce_tilts(spec):
    """Frozen split of :func:`make_enforce_tilts` (positions constant)."""

    def precompute(state, topo, params):
        rows, r_dir, ok = _directions(state.positions, topo)
        return {"rows": rows, "r_dir": r_dir, "ok": ok}

    def enforce(tin, tout, fr, topo, params):
        return _apply(tin, fr["rows"], fr["r_dir"], fr["ok"], params), tout

    return precompute, enforce
