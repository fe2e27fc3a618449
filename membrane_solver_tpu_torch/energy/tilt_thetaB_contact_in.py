"""Inner-leaflet theta_B contact work term (Kozlov scalar boundary mode).

Counterpart of ``membrane_solver_tpu/energy/tilt_thetaB_contact_in.py``.  In
the default scalar work mode

    E = -2 pi R_eff gamma theta_B

with R_eff the arc-length-weighted effective radius of the theta_B group
ring; the term carries no gradient (positions and theta_B are detached).
``tilt_thetaB_contact_work_mode`` ``field_linear`` puts the ring's
arc-length-weighted mean radial tilt in place of theta_B, which makes the
term linear in the inner tilts.  ``tilt_thetaB_contact_penalty_mode``
``legacy`` (or on, true, 1) adds the quadratic penalty

    0.5 k sum_i w_i (t_in,i . r_hat_i - theta_B)^2

with its exact tilt gradient, and :func:`update_scalar_params` moves
theta_B to the penalty's closed-form optimum on the host, once per
iteration of ``Minimizer.minimize``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from membrane_solver_tpu_torch.device.reduce import member_sum, tree_sum
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


def ring_tables(layout, rows, center, normal, has_normal: bool) -> dict:
    """The ring's extras: ``rows`` in angular order about ``center`` and ``normal``.

    Shared with ``tilt_disk_contact_in``, whose ring is ordered the same way.
    """
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


def compile_topology(layout) -> dict:
    gp = layout.mesh.global_parameters
    center = np.asarray(gp.get("tilt_thetaB_center") or [0, 0, 0], dtype=float)
    raw_n = gp.get("tilt_thetaB_normal")
    if raw_n is not None:
        normal = np.asarray(raw_n, dtype=float)
        nn = np.linalg.norm(normal)
        normal = normal / nn if nn > 1e-15 else np.array([0.0, 0.0, 1.0])
    else:
        normal = np.array([0.0, 0.0, 1.0])
    return ring_tables(layout, _group_rows(layout), center, normal, raw_n is not None)


def ring_geometry(positions, topo, prefix: str = _PREFIX, total=member_sum):
    """(valid mask, weights, r_hat, r_len, wsum, R_eff) for the ring of ``prefix``'s extras.

    ``total`` sums the ring's weights: ``tilt_disk_contact_in`` passes
    ``device/reduce.tree_sum``.  This module's own ring keeps the order of
    ``torch.sum``: its frozen geometry feeds every iteration of the kozlov
    lane's leaflet relax, whose float64 floor decides near-ties (ROADMAP C3),
    and a halving tree flips one of them.  ``device/reduce.member_sum`` is
    that single call, and under ``torch.func.vmap`` that call once per sweep
    member, so a member's ring is its single call's bits at any member count.
    """
    rows = topo.extras[f"{prefix}/rows"]
    valid = topo.extras[f"{prefix}/valid"]
    center = topo.extras[f"{prefix}/center"].to(positions.dtype)
    normal = topo.extras[f"{prefix}/normal"].to(positions.dtype)
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
    wsum = total(weights)
    r_eff = total(weights * r_len) / torch.clamp(wsum, min=1e-12)
    return good, weights, r_hat, r_len, wsum, r_eff


_PENALTY_ON = frozenset({"legacy", "on", "true", "1"})


def _modes(spec):
    """(legacy penalty on, field-linear work) of the spec's static options."""
    penalty = spec.option("tilt_thetaB_contact_penalty_mode", "off").lower() in _PENALTY_ON
    return penalty, spec.option("tilt_thetaB_contact_work_mode", "scalar").lower() == "field_linear"


def _term(tin, ring, topo, params, penalty: bool, field_linear: bool):
    """The work term (and the penalty) of the inner tilts on the ring's frozen geometry."""
    good, weights, r_hat, wsum, r_eff = ring
    gamma = param(params, "tilt_thetaB_contact_strength_in", like=tin)
    theta_B = param(params, "tilt_thetaB_value", like=tin)
    theta_vals = torch.sum(tin[topo.extras[f"{_PREFIX}/rows"]] * r_hat, dim=1)
    if field_linear:
        theta_contact = tree_sum(weights * theta_vals) / torch.clamp(wsum, min=1e-12)
    else:
        theta_contact = theta_B.detach()
    E = tin.new_zeros(()) - 2.0 * math.pi * r_eff * gamma * theta_contact
    if penalty:
        k = param(params, "tilt_thetaB_strength_in", like=tin)
        diff = theta_vals - theta_B
        E = E + 0.5 * k * tree_sum(torch.where(good, weights * diff * diff, 0.0))
    return E


def _frozen_ring(positions, topo):
    good, weights, r_hat, _r_len, wsum, r_eff = ring_geometry(positions.detach(), topo)
    return good, weights, r_hat, wsum, r_eff


def make_energy(spec):
    penalty, field_linear = _modes(spec)

    def fn(geo, state, topo, params):
        if f"{_PREFIX}/rows" not in topo.extras:
            return state.positions.new_zeros(())
        return _term(state.tilts_in, _frozen_ring(state.positions, topo), topo, params,
                     penalty, field_linear)

    return fn


def make_tilt_frozen(spec):
    """Frozen-geometry split for the inner tilt solve (positions constant).

    The ring geometry is baked once per relax call; only the tilts' radial
    projections change per iteration (in the scalar work mode without the
    penalty the term is constant in the tilts).
    """
    penalty, field_linear = _modes(spec)

    def precompute(state, topo, params):
        if f"{_PREFIX}/rows" not in topo.extras:
            return {}
        return {"ring": _frozen_ring(state.positions, topo)}

    def energy_fn(tin, tout, fr, topo, params, ctx=None):
        if not fr:
            return tin.new_zeros(())
        return _term(tin, fr["ring"], topo, params, penalty, field_linear)

    return precompute, energy_fn


def _group_of(global_params):
    mode = str(global_params.get("tilt_thetaB_contact_penalty_mode") or "off").lower()
    if mode not in _PENALTY_ON:
        return None
    return global_params.get("tilt_thetaB_group_in") or global_params.get(
        "rim_slope_match_disk_group")


def scalar_update_live(mesh, global_params) -> bool:
    """True when :func:`update_scalar_params` moves theta_B: the legacy penalty, a group, k > 0."""
    if _group_of(global_params) is None:
        return False
    return float(global_params.get("tilt_thetaB_strength_in") or 0.0) > 0.0


def update_scalar_params(mesh, global_params) -> None:
    """The legacy penalty's closed-form theta_B, from the host mesh (host side, float64).

    The group's vertices (by id) in angular order about ``tilt_thetaB_center``
    and ``tilt_thetaB_normal`` (else the group's least-squares plane normal),
    arc-length weights from that order, and

        theta_B = mean_w(t_in . r_hat) + 2 pi R_eff gamma / (k sum w)

    written to ``tilt_thetaB_value``; k and gamma are the global parameters.
    """
    group = _group_of(global_params)
    if group is None:
        return
    group = str(group).strip()
    center = np.asarray(global_params.get("tilt_thetaB_center") or [0, 0, 0], dtype=float)
    raw_n = global_params.get("tilt_thetaB_normal")
    vids = [vid for vid in sorted(mesh.vertices)
            if (mesh.vertices[vid].options or {}).get("rim_slope_match_group") == group
            or (mesh.vertices[vid].options or {}).get("tilt_thetaB_group") == group]
    if not vids:
        return
    pos = np.array([mesh.vertices[v].position for v in vids], dtype=float)
    if raw_n is not None:
        normal = np.asarray(raw_n, dtype=float)
        normal = normal / max(np.linalg.norm(normal), 1e-15)
    else:
        _u, _s, vh = np.linalg.svd(pos - pos.mean(axis=0), full_matrices=False)
        normal = vh[-1]
    rel = pos - center
    rel -= np.outer(rel @ normal, normal)
    trial = np.array([1.0, 0, 0]) if abs(normal[0]) <= 0.9 else np.array([0, 1.0, 0])
    u = trial - (trial @ normal) * normal
    u /= max(np.linalg.norm(u), 1e-15)
    order = np.argsort(np.arctan2(rel @ np.cross(normal, u), rel @ u))
    vids = [vids[i] for i in order]
    pos = pos[order]
    n = len(vids)
    l_next = np.linalg.norm(pos[(np.arange(n) + 1) % n] - pos, axis=1)
    l_prev = np.linalg.norm(pos - pos[(np.arange(n) - 1) % n], axis=1)
    weights = 0.5 * (l_next + l_prev)
    rel = pos - center
    rel -= np.outer(rel @ normal, normal)
    r_len = np.linalg.norm(rel, axis=1)
    good = r_len > 1e-12
    if not np.any(good):
        return
    weights = weights[good]
    r_hat = rel[good] / r_len[good][:, None]
    wsum = float(np.sum(weights))
    if wsum <= 1e-12:
        return
    tilts = np.array([mesh.vertices[v].tilt_in for v in np.asarray(vids)[good]], dtype=float)
    theta_mean = float(np.sum(weights * np.einsum("ij,ij->i", tilts, r_hat)) / wsum)
    r_eff = float(np.sum(weights * r_len[good]) / wsum)
    k = float(global_params.get("tilt_thetaB_strength_in") or 0.0)
    gamma = float(global_params.get("tilt_thetaB_contact_strength_in") or 0.0)
    if k <= 0.0:
        return
    global_params.set("tilt_thetaB_value", float(theta_mean + (2.0 * np.pi * r_eff * gamma)
                                                 / (k * wsum)))
