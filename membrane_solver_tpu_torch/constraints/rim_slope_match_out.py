"""Hard rim-matching constraint: outer-leaflet tilt vs slope (gamma = 0).

Counterpart of ``membrane_solver_tpu/constraints/rim_slope_match_out.py`` in
its default ``pointwise_radial_v1`` mode with a disk group and the scalar
theta law (``rim_slope_match_thetaB_param``):

    phi_i = (h_out_i - h_rim_i) / (r_out_i - r_rim_i)      (slope per rim vertex)
    t_out . r_dir_i = phi_i                                 (outer condition)
    t_in  . r_dir_i = theta_B - phi_i                       (inner condition)

with r_dir_i the rim vertex's tangent-projected radial direction.  The
in-rows of the tilt KKT projection subtract the disk-side term: the paired
disk row's direction when the disk and rim rings pair 1:1 (``local_disk``),
else the arc-length mean over the whole disk ring, a rank-1 background
shared by every in-row.  Rim and outer rings have equal counts on this
lane, so the outer ring pairs 1:1 with the rim.  Every other matching flag
(``_spec_flags`` of the JAX module: interpolated outer ring, disk-ring
theta, staggered and physical-edge placements, ring averaging, scaffold
trace) raises NotImplementedError when the problem is compiled.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.state import check_unique_rows
from membrane_solver_tpu_torch.energy import param

_KEY = "constraint:rim_slope_match_out"


def _tiny(dtype) -> float:
    return 1e-300 if dtype == torch.float64 else 1e-30


def _group_rows(layout, group):
    mesh = layout.mesh
    rows = []
    for vid in sorted(mesh.vertices):
        opts = mesh.vertices[vid].options or {}
        if str(opts.get("rim_slope_match_group") or "") == str(group):
            rows.append(layout.row_of[int(vid)])
    return rows


def _order_ring(layout, rows, center, normal):
    pos = np.array([layout.mesh.vertices[int(layout.vertex_ids[r])].position for r in rows])
    rel = pos - center
    rel -= np.outer(rel @ normal, normal)
    trial = np.array([1.0, 0, 0]) if abs(normal[0]) <= 0.9 else np.array([0, 1.0, 0])
    u = trial - (trial @ normal) * normal
    u /= max(np.linalg.norm(u), 1e-15)
    v = np.cross(normal, u)
    order = np.argsort(np.arctan2(rel @ v, rel @ u))
    return [rows[i] for i in order]


def _rings(layout):
    """(rim, outer, disk) row lists, or None when the matching is inactive."""
    gp = layout.mesh.global_parameters
    group = gp.get("rim_slope_match_group")
    outer_group = gp.get("rim_slope_match_outer_group")
    disk_group = gp.get("rim_slope_match_disk_group")
    if group is None or outer_group is None:
        return None
    if disk_group is not None and str(disk_group) == str(group):
        disk_group = None  # degenerate disk==rim coupling is disabled
    rim = _group_rows(layout, group)
    outer = _group_rows(layout, outer_group)
    if not rim or not outer:
        return None
    disk = _group_rows(layout, disk_group) if disk_group is not None else []
    return rim, outer, disk


def compile_static(layout):
    """Flags (active, has_disk, interp_outer, local_disk, theta_is_param, ...).

    The tuple has the JAX module's layout; the port raises for every value
    other than the lane's.
    """
    rings = _rings(layout)
    if rings is None:
        return ("inactive",)
    rim, outer, disk = rings
    gp = layout.mesh.global_parameters
    flags = (
        "active",
        bool(disk),
        len(outer) != len(rim),
        bool(disk) and len(disk) == len(rim),
        gp.get("rim_slope_match_thetaB_param") is not None,
        False,      # staggered (shared_rim_staggered_v1)
        False,      # disk_targeting
        False,      # ring_average
        False,      # scaffold
        "project",  # mesh_op_mode
        "",         # projector_mode
        False,      # has_trace
    )
    for name, value, ported in (
        ("has_disk (rim_slope_match_disk_group)", flags[1], True),
        ("interp_outer (rim and outer rings of unequal size)", flags[2], False),
        ("theta_is_param (rim_slope_match_thetaB_param)", flags[4], True),
    ):
        if value != ported:
            raise NotImplementedError(
                f"rim_slope_match_out flag {name}={value} is not ported to "
                "membrane_solver_tpu_torch"
            )
    return flags


def compile_topology(layout) -> dict:
    gp = layout.mesh.global_parameters
    center = np.asarray(gp.get("rim_slope_match_center") or [0, 0, 0], dtype=float)
    normal = np.asarray(gp.get("rim_slope_match_normal") or [0, 0, 1], dtype=float)
    normal /= max(np.linalg.norm(normal), 1e-15)

    def ring(rows):
        rows = _order_ring(layout, rows, center, normal) if rows else []
        return (
            np.asarray(rows or [0], dtype=np.int64),
            np.ones(len(rows), dtype=bool) if rows else np.zeros(1, dtype=bool),
        )

    rim, outer, disk = _rings(layout) or ([], [], [])
    # the rim, outer and disk rows are distinct, so the index_add and
    # index_put calls below add one value per row (exact in any order)
    check_unique_rows(rim + outer + disk, "rim_slope_match_out rim, outer and disk rings")
    rim_arr, rim_valid = ring(rim)
    outer_arr, outer_valid = ring(outer)
    disk_arr, disk_valid = ring(disk)
    return {
        "rim": rim_arr,
        "outer": outer_arr,
        "disk": disk_arr,
        "valid": rim_valid,
        "outer_valid": outer_valid,
        "disk_valid": disk_valid,
        "center": center,
        "normal": normal,
    }


def _x(topo, key):
    return topo.extras[f"{_KEY}/{key}"]


def _spec_flags(spec):
    """(has_disk, local_disk) on an active lane, else None."""
    flags = spec.static_of(_KEY, ("inactive",))
    if flags[0] != "active":
        return None
    return bool(flags[1]), bool(flags[3])


def _ring_weights(pos, live):
    """Arc-length weights 0.5 (|p_next - p| + |p - p_prev|) on a closed ring."""
    k = pos.shape[0]
    idx = torch.arange(k, device=pos.device)
    n_live = torch.sum(live.to(torch.int64))
    nxt = torch.where(idx + 1 >= n_live, 0, idx + 1)
    prv = torch.where(idx - 1 < 0, n_live - 1, idx - 1)
    l_next = torch.linalg.vector_norm(pos[nxt] - pos, dim=1)
    l_prev = torch.linalg.vector_norm(pos - pos[prv], dim=1)
    return 0.5 * (l_next + l_prev)


def matching_data(positions, topo):
    """Live matching payload (valid, phi, inv_dr, r_hat, weights, normal).

    Recomputed from the current positions at every evaluation; the outer
    ring pairs 1:1 with the rim ring.
    """
    dtype = positions.dtype
    rim = _x(topo, "rim")
    outer = _x(topo, "outer")
    ring_valid = _x(topo, "valid")
    center = _x(topo, "center").to(dtype)
    normal = _x(topo, "normal").to(dtype)

    rim_pos = positions[rim]
    rel = rim_pos - center
    rel_p = rel - torch.sum(rel * normal, dim=1, keepdim=True) * normal
    r_len = torch.linalg.vector_norm(rel_p, dim=1)
    good = ring_valid & (r_len > 1e-12)
    r_hat = torch.where(good[:, None], rel_p / torch.clamp(r_len, min=1e-12)[:, None], 0.0)

    outer_pos = positions[outer]
    h_rim = torch.sum((rim_pos - center) * normal, dim=1)
    h_out = torch.sum((outer_pos - center) * normal, dim=1)
    rel_o = outer_pos - center
    rel_op = rel_o - torch.sum(rel_o * normal, dim=1, keepdim=True) * normal
    r_out = torch.linalg.vector_norm(rel_op, dim=1)
    dr = r_out - r_len
    valid = good & (torch.abs(dr) > 1e-8)
    inv_dr = torch.where(valid, 1.0 / torch.where(valid, dr, 1.0), 0.0)
    phi = torch.where(valid, (h_out - h_rim) * inv_dr, 0.0)
    weights = torch.where(valid, _ring_weights(rim_pos, ring_valid), 0.0)
    return valid, phi, inv_dr, r_hat, weights, normal


def _tangent_radial(r_hat, vnormals, rows):
    n = vnormals[rows]
    r_dir = r_hat - torch.sum(r_hat * n, dim=1, keepdim=True) * n
    norm = torch.linalg.vector_norm(r_dir, dim=1)
    ok = norm > 1e-12
    return torch.where(ok[:, None], r_dir / torch.clamp(norm, min=1e-12)[:, None], 0.0), ok


def _disk_geometry(positions, topo):
    """(disk rows, valid, r_hat, arc-length weights) for the disk ring."""
    dtype = positions.dtype
    disk = _x(topo, "disk")
    disk_valid = _x(topo, "disk_valid")
    center = _x(topo, "center").to(dtype)
    normal = _x(topo, "normal").to(dtype)
    disk_pos = positions[disk]
    rel = disk_pos - center
    rel_p = rel - torch.sum(rel * normal, dim=1, keepdim=True) * normal
    dlen = torch.linalg.vector_norm(rel_p, dim=1)
    good = disk_valid & (dlen > 1e-12)
    disk_r_hat = torch.where(good[:, None], rel_p / torch.clamp(dlen, min=1e-12)[:, None], 0.0)
    w = torch.where(good, _ring_weights(disk_pos, disk_valid), 0.0)
    return disk, good, disk_r_hat, w


def _rim_directions(positions, topo):
    """(valid, phi, weights, r_dir, use) with r_dir tangent to the live surface."""
    valid, phi, _inv_dr, r_hat, weights, _normal = matching_data(positions, topo)
    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    vnormals = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())
    r_dir, dir_ok = _tangent_radial(r_hat, vnormals, _x(topo, "rim"))
    return phi, weights, r_dir, valid & dir_ok


def _apply_tilts(tin, tout, rim, phi, r_dir, ok_out, ok_in, params):
    """Project the outer and inner matching conditions on the rim rows."""
    t_out_rad = torch.sum(tout[rim] * r_dir, dim=1)
    delta_out = torch.where(ok_out, phi - t_out_rad, 0.0)
    tout = tout.index_add(0, rim, delta_out[:, None] * r_dir)
    theta = param(params, "tilt_thetaB_value", like=tin)
    t_in_rad = torch.sum(tin[rim] * r_dir, dim=1)
    delta_in = torch.where(ok_in, (theta - phi) - t_in_rad, 0.0)
    return tin.index_add(0, rim, delta_in[:, None] * r_dir), tout


def make_enforce_tilts(spec):
    if _spec_flags(spec) is None:
        return None

    def enforce(state, topo, params):
        phi, _w, r_dir, use = _rim_directions(state.positions, topo)
        rim = _x(topo, "rim")
        tin, tout = _apply_tilts(
            state.tilts_in, state.tilts_out, rim, phi, r_dir,
            use & ~topo.tilt_fixed_out_mask[rim], use & ~topo.tilt_fixed_in_mask[rim], params,
        )
        return dataclasses.replace(state, tilts_in=tin, tilts_out=tout)

    return enforce


def make_frozen_enforce_tilts(spec):
    """Frozen split of :func:`make_enforce_tilts` (positions constant)."""
    if _spec_flags(spec) is None:
        return None

    def precompute(state, topo, params):
        phi, _w, r_dir, use = _rim_directions(state.positions, topo)
        rim = _x(topo, "rim")
        return {
            "rim": rim,
            "phi": phi,
            "r_dir": r_dir,
            "ok_out": use & ~topo.tilt_fixed_out_mask[rim],
            "ok_in": use & ~topo.tilt_fixed_in_mask[rim],
        }

    def enforce(tin, tout, fr, topo, params):
        return _apply_tilts(
            tin, tout, fr["rim"], fr["phi"], fr["r_dir"], fr["ok_out"], fr["ok_in"], params
        )

    return precompute, enforce


def make_enforce(spec):
    """Geometric enforcement: the JAX module projects heights only on the
    physical-edge trace lanes; on the pointwise lane it has none."""
    return None


def _mean_disk_field(disk, dgood, disk_r_hat, dw, n_rows):
    """(Nv, 3) arc-length-mean disk direction field shared by every in-row."""
    wsum = torch.sum(torch.where(dgood, dw, 0.0))
    mean_dirs = (dw / torch.clamp(wsum, min=_tiny(dw.dtype)))[:, None] * disk_r_hat
    return disk_r_hat.new_zeros((n_rows, 3)).index_add(
        0, disk, torch.where(dgood[:, None], mean_dirs, 0.0)
    )


def make_compact_tilt_rows(spec):
    """Compact tilt rows: out rows touch one (rim, out) slot; in rows touch
    (rim, in) plus the paired (disk, in) slot (local disk), or (rim, in)
    plus a rank-1 background, the arc-length-mean disk field shared by every
    in-row."""
    flags = _spec_flags(spec)
    if flags is None:
        return lambda state, topo, params: None
    _has_disk, local_disk = flags

    def fn(state, topo, params):
        positions = state.positions
        _phi, weights, r_dir, use = _rim_directions(positions, topo)
        rim = _x(topo, "rim")
        coeff = torch.where(use, torch.sqrt(torch.clamp(weights, min=0.0)), 0.0)
        k = rim.shape[0]
        base_val = coeff[:, None] * r_dir
        base_row = torch.where(use, rim, 0)
        disk, dgood, disk_r_hat, dw = _disk_geometry(positions, topo)
        if local_disk:
            zero_val = torch.zeros_like(base_val)
            zero_row = torch.zeros_like(base_row)
            out_vals = torch.stack([base_val, zero_val], dim=1)
            out_rows = torch.stack([base_row, zero_row], dim=1)
            in_vals = torch.stack(
                [base_val, torch.where(dgood[:, None], -coeff[:, None] * disk_r_hat, 0.0)],
                dim=1,
            )
            in_rows = torch.stack([base_row, torch.where(dgood, disk, 0)], dim=1)
            return (
                torch.cat([out_vals, in_vals]),
                torch.cat([out_rows, in_rows]),
                torch.cat([torch.ones_like(out_rows), torch.zeros_like(in_rows)]),
            )
        n_rows = positions.shape[0]
        shared_in = _mean_disk_field(disk, dgood, disk_r_hat, dw, n_rows)
        bg_field = torch.stack([shared_in, torch.zeros_like(shared_in)])  # (2, Nv, 3)
        vals = torch.cat([base_val, base_val])[:, None, :]
        rows = torch.cat([base_row, base_row])[:, None]
        leaf = torch.cat([torch.ones_like(base_row), torch.zeros_like(base_row)])[:, None]
        bg_coeff = torch.cat([coeff.new_zeros((k,)), -coeff])
        return vals, rows, leaf, bg_coeff, bg_field

    return fn


def _shape_rows(positions, topo):
    """(rim, outer, coeff, normal): one shape condition per rim vertex."""
    valid, _phi, inv_dr, _r_hat, weights, normal = matching_data(positions, topo)
    coeff = torch.where(valid, torch.sqrt(torch.clamp(weights, min=0.0)) * inv_dr, 0.0)
    return _x(topo, "rim"), _x(topo, "outer"), coeff, valid, normal


def make_constraint_gradient_rows(spec):
    """Dense shape KKT rows tying rim/outer heights, one per rim vertex.

    As in the JAX package, the in-condition rows (exact negations of the
    out rows) are dropped: same span, well-conditioned system.
    """
    if _spec_flags(spec) is None:
        return lambda state, topo, params: None

    def fn(state, topo, params):
        positions = state.positions
        rim, outer, coeff, _valid, nvec = _shape_rows(positions, topo)
        k = rim.shape[0]
        idx = torch.arange(k, device=rim.device)
        g = positions.new_zeros((k, positions.shape[0], 3))
        g = g.index_put((idx, rim), coeff[:, None] * nvec)
        return g.index_put((idx, outer), -coeff[:, None] * nvec)

    return fn


def make_compact_constraint_rows(spec):
    """Compact form of the shape rows: (values (K, 2, 3), rows (K, 2)).

    The JAX module carries a third slot for the second outer row of an
    interpolated pairing; with the 1:1 pairing its value is zero.
    """
    if _spec_flags(spec) is None:
        return None

    def fn(state, topo, params):
        positions = state.positions
        rim, outer, coeff, valid, nvec = _shape_rows(positions, topo)
        slot_vals = torch.stack([coeff[:, None] * nvec, -coeff[:, None] * nvec], dim=1)
        # rows fixed per topology (the KKT projector keeps their slot CSR);
        # a rim vertex that this state leaves out has a zero coefficient
        slot_rows = torch.stack([rim, outer], dim=1)
        slot_rows = torch.where(_x(topo, "valid")[:, None], slot_rows, positions.shape[0] - 1)
        return slot_vals, slot_rows

    return fn
