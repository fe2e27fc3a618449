"""Hard rim director continuity: in-plane tilt_in equal to tilt_out on a tagged ring.

Counterpart of ``membrane_solver_tpu/constraints/tilt_leaflet_match_rim.py``:
on the vertices whose ``tilt_leaflet_match_group`` option equals the global
parameter of that name, both in-plane components in the ring's (u, v)
basis (fitted once, when the problem is compiled) must agree between the
leaflets.  KKT rows: per basis vector one joint row, +dvec on the
in-leaflet block and -dvec on the out-leaflet block at every ring row.
Enforcement sets both leaflets' components to their mean, or to the inner
(``in_to_out``) or outer (``out_to_in``) ones (``tilt_leaflet_match_mode``),
a fixed side keeping its own.  The ring rows are distinct, so every write
is one value per row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.device.state import check_unique_rows

_PREFIX = "constraint:tilt_leaflet_match_rim"


def _basis_from_points(pos: np.ndarray):
    centroid = pos.mean(axis=0)
    _, _, vh = np.linalg.svd(pos - centroid, full_matrices=False)
    normal = vh[-1]
    trial = np.array([1.0, 0.0, 0.0])
    if abs(float(trial @ normal)) > 0.9:
        trial = np.array([0.0, 1.0, 0.0])
    u = trial - float(trial @ normal) * normal
    u /= max(np.linalg.norm(u), 1e-15)
    v = np.cross(normal, u)
    v /= max(np.linalg.norm(v), 1e-15)
    return u, v


def compile_static(layout):
    gp = layout.mesh.global_parameters
    mode = str(gp.get("tilt_leaflet_match_mode") or "average").strip().lower()
    if mode not in {"average", "in_to_out", "out_to_in"}:
        mode = "average"
    return (mode,)


def compile_topology(layout) -> dict:
    mesh = layout.mesh
    empty = {
        "rows": np.zeros(1, dtype=np.int64),
        "valid": np.zeros(1, dtype=bool),
        "u": np.array([1.0, 0.0, 0.0]),
        "v": np.array([0.0, 1.0, 0.0]),
    }
    group = mesh.global_parameters.get("tilt_leaflet_match_group")
    if group is None or not str(group).strip():
        return empty
    group = str(group).strip()
    rows = [
        layout.row_of[int(vid)]
        for vid in sorted(mesh.vertices)
        if (mesh.vertices[vid].options or {}).get("tilt_leaflet_match_group") == group
    ]
    if not rows:
        return empty
    check_unique_rows(rows, "tilt_leaflet_match_rim rows")
    pos = np.array([mesh.vertices[int(layout.vertex_ids[r])].position for r in rows])
    u, v = _basis_from_points(pos)
    return {
        "rows": np.asarray(rows, dtype=np.int64),
        "valid": np.ones(len(rows), dtype=bool),
        "u": u,
        "v": v,
    }


def make_tilt_constraint_rows(spec):
    def fn(state, topo, params):
        if f"{_PREFIX}/rows" not in topo.extras:
            return None
        x = lambda k: topo.extras[f"{_PREFIX}/{k}"]  # noqa: E731
        rows = x("rows")
        valid = x("valid")
        dtype = state.positions.dtype
        zeros = state.positions.new_zeros((state.positions.shape[0], 3))
        out = []
        for key in ("u", "v"):
            g = zeros.index_put((rows,), torch.where(valid[:, None], x(key).to(dtype), 0.0))
            out.append(torch.stack([g, -g], dim=0))  # (2=in/out, Nv, 3)
        return torch.stack(out, dim=0)

    return fn


def make_enforce_tilts(spec):
    mode = spec.static_of(_PREFIX, ("average",))[0]

    def enforce(state, topo, params):
        if f"{_PREFIX}/rows" not in topo.extras:
            return state
        x = lambda k: topo.extras[f"{_PREFIX}/{k}"]  # noqa: E731
        rows = x("rows")
        valid = x("valid")
        dtype = state.positions.dtype
        u = x("u").to(dtype)
        v = x("v").to(dtype)
        fixed_in = topo.tilt_fixed_in_mask[rows]
        fixed_out = topo.tilt_fixed_out_mask[rows]

        tin = state.tilts_in
        tout = state.tilts_out
        din = torch.stack([torch.sum(tin[rows] * u, dim=1), torch.sum(tin[rows] * v, dim=1)], dim=1)
        dout = torch.stack([torch.sum(tout[rows] * u, dim=1), torch.sum(tout[rows] * v, dim=1)],
                           dim=1)
        if mode == "in_to_out":
            target = din
        elif mode == "out_to_in":
            target = dout
        else:
            target = 0.5 * (din + dout)
            target = torch.where(fixed_in[:, None], din, target)
            target = torch.where(fixed_out[:, None], dout, target)
        both_fixed = fixed_in & fixed_out
        ok_in = valid & ~fixed_in & ~both_fixed
        ok_out = valid & ~fixed_out & ~both_fixed
        delta_in = (target[:, 0] - din[:, 0])[:, None] * u + (target[:, 1] - din[:, 1])[:, None] * v
        delta_out = (target[:, 0] - dout[:, 0])[:, None] * u + (
            target[:, 1] - dout[:, 1])[:, None] * v
        tin = tin.index_add(0, rows, torch.where(ok_in[:, None], delta_in, 0.0))
        tout = tout.index_add(0, rows, torch.where(ok_out[:, None], delta_out, 0.0))
        return dataclasses.replace(state, tilts_in=tin, tilts_out=tout)

    return enforce
