"""Inner-leaflet theta_B contact work term (Kozlov scalar boundary mode).

Counterpart of ``membrane_solver_tpu/energy/tilt_thetaB_contact_in.py`` in
its default scalar work mode:

    E = -2 pi R_eff gamma theta_B

with R_eff the arc-length-weighted effective radius of the theta_B group
ring.  The term carries no gradient (positions and theta_B are detached).
The legacy penalty and field-linear work modes are not ported; their static
options raise NotImplementedError when the problem is compiled.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from membrane_solver_tpu_torch.energy import param

USES_TILT_LEAFLETS = True
IS_EXTERNAL_WORK = True

_PREFIX = "energy:tilt_thetaB_contact_in"


def _group_rows(layout):
    mesh = layout.mesh
    gp = mesh.global_parameters
    group = gp.get("tilt_thetaB_group_in") or gp.get("rim_slope_match_disk_group")
    if group is None:
        return []
    group = str(group).strip()
    rows = []
    for vid in sorted(mesh.vertices):
        opts = mesh.vertices[vid].options or {}
        if opts.get("rim_slope_match_group") == group or opts.get("tilt_thetaB_group") == group:
            rows.append(layout.row_of[int(vid)])
    return rows


def compile_topology(layout) -> dict:
    rows = _group_rows(layout)
    gp = layout.mesh.global_parameters
    center = np.asarray(gp.get("tilt_thetaB_center") or [0, 0, 0], dtype=float)
    raw_n = gp.get("tilt_thetaB_normal")
    if raw_n is not None:
        normal = np.asarray(raw_n, dtype=float)
        nn = np.linalg.norm(normal)
        normal = normal / nn if nn > 1e-15 else np.array([0.0, 0.0, 1.0])
        has_normal = True
    else:
        normal = np.array([0.0, 0.0, 1.0])
        has_normal = False
    # ring order fixed at compile time (pinned rings keep their angular order)
    if len(rows) >= 2:
        pos = np.array([layout.mesh.vertices[int(layout.vertex_ids[r])].position for r in rows])
        rel = pos - center
        rel -= np.outer(rel @ normal, normal)
        trial = np.array([1.0, 0, 0]) if abs(normal[0]) <= 0.9 else np.array([0, 1.0, 0])
        u = trial - (trial @ normal) * normal
        u /= max(np.linalg.norm(u), 1e-15)
        v = np.cross(normal, u)
        order = np.argsort(np.arctan2(rel @ v, rel @ u))
        rows = [rows[i] for i in order]
    return {
        "rows": np.asarray(rows or [0], dtype=np.int64),
        "valid": np.ones(len(rows), dtype=bool) if rows else np.zeros(1, dtype=bool),
        "center": center,
        "normal": normal,
        "has_normal": np.asarray(has_normal),
    }


def ring_geometry(positions, topo):
    """(valid mask, weights, r_hat, r_len, wsum, R_eff) for the theta_B ring."""
    rows = topo.extras[f"{_PREFIX}/rows"]
    valid = topo.extras[f"{_PREFIX}/valid"]
    center = topo.extras[f"{_PREFIX}/center"].to(positions.dtype)
    normal = topo.extras[f"{_PREFIX}/normal"].to(positions.dtype)
    pts = positions[rows]
    k = rows.shape[0]
    idx = torch.arange(k, device=rows.device)
    n_live = torch.sum(valid.to(torch.int64))
    nxt = torch.where(idx + 1 >= n_live, 0, idx + 1)
    prv = torch.where(idx - 1 < 0, n_live - 1, idx - 1)
    l_next = torch.linalg.vector_norm(pts[nxt] - pts, dim=1)
    l_prev = torch.linalg.vector_norm(pts - pts[prv], dim=1)
    weights = torch.where(valid, 0.5 * (l_next + l_prev), 0.0)
    rel = pts - center
    rel_p = rel - torch.sum(rel * normal, dim=1, keepdim=True) * normal
    r_len = torch.linalg.vector_norm(rel_p, dim=1)
    good = valid & (r_len > 1e-12)
    r_hat = torch.where(good[:, None], rel_p / torch.clamp(r_len, min=1e-12)[:, None], 0.0)
    weights = torch.where(good, weights, 0.0)
    wsum = torch.sum(weights)
    r_eff = torch.sum(weights * r_len) / torch.clamp(wsum, min=1e-12)
    return good, weights, r_hat, r_len, wsum, r_eff


def _work(r_eff, params, like):
    gamma = param(params, "tilt_thetaB_contact_strength_in", like=like)
    theta_B = param(params, "tilt_thetaB_value", like=like).detach()
    return like.new_zeros(()) - 2.0 * math.pi * r_eff * gamma * theta_B


def make_energy(spec):
    def fn(geo, state, topo, params):
        if f"{_PREFIX}/rows" not in topo.extras:
            return state.positions.new_zeros(())
        _g, _w, _r, _l, _s, r_eff = ring_geometry(state.positions.detach(), topo)
        return _work(r_eff, params, state.positions)

    return fn


def make_tilt_frozen(spec):
    """Frozen-geometry split for the inner tilt solve (positions constant).

    In the scalar work mode the whole term is constant in the tilts.
    """

    def precompute(state, topo, params):
        if f"{_PREFIX}/rows" not in topo.extras:
            return {}
        _g, _w, _r, _l, _s, r_eff = ring_geometry(state.positions.detach(), topo)
        return {"r_eff": r_eff}

    def energy_fn(tin, tout, fr, topo, params, ctx=None):
        if not fr:
            return tin.new_zeros(())
        return _work(fr["r_eff"], params, tin)

    return precompute, energy_fn
