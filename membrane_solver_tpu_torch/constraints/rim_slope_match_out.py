"""Hard rim-matching constraint: outer-leaflet tilt vs slope (gamma = 0).

Counterpart of ``membrane_solver_tpu/constraints/rim_slope_match_out.py``:

    phi_i = (h_out_i - h_rim_i) / (r_out_i - r_rim_i)      (slope per rim vertex)
    t_out . r_dir_i = phi_i                                 (outer condition)
    t_in  . r_dir_i = theta_i - phi_i                       (inner condition)

with r_dir_i the rim vertex's tangent-projected radial direction and h/r
heights and radii about (center, normal).  The ``rim_slope_match_mode``s:

- ``pointwise_radial_v1`` (default): one condition per rim vertex on the
  rim row;
- ``ring_average_radial_v1``: every condition of a leaflet family
  aggregated into one (enforcement applies one arc-weighted mean correction
  to the whole ring; one dense tilt row per family, one dense shape row);
- ``shared_rim_staggered_v1``: the conditions act on the (interpolated)
  outer-ring rows instead of the rim row, along r_hat tangent-projected
  with the weight-blended normal of those rows (and the minimize block
  restricts shape descent to heights, ``runtime/jit_core``).

- ``physical_edge_staggered_v1``: the local-shell placement
  (``local_interface_shells.build_shell_rows`` about the disk group): the
  "rim" of the matching is the disk group, each row paired with the
  nearest-azimuth row of the first free shell (or, with
  ``parity_trace_layer_radius``, of the shell nearest that radius: the
  trace shell), staggered.  Without ``parity_outer_shells`` it is the
  disk-targeted flavour: the inner condition acts on the disk row itself
  along the planar radial with the scalar theta_B target.  With
  ``parity_trace_layer_radius`` and ``parity_outer_shells`` > 0 (the
  scaffold-trace lane) theta comes from the disk rows' tilts and the inner
  condition is staggered as the outer one.  With a trace radius the
  geometric enforcement (:func:`make_enforce`) also projects the trace
  shell's heights and outer radial tilts (a joint proximal solve, or
  ``rim_slope_match_scaffold_projector_mode`` ``continuity_v2``), skipped
  in mesh-operation and finalize contexts under
  ``rim_slope_match_scaffold_mesh_operation_mode`` ``preserve_trace_v1``.

When the rim and outer rings differ in size, the outer ring is sampled at
each rim vertex's normalized arc length (rows idx0, idx1 with weights
w0, w1).  The staggered enforcement runs the conditions one after the
other, as the reference's loop does: one at a time on the interpolated
pairing (adjacent conditions share a target row), and in levels on the
others, whose rows are fixed per topology: a condition's level is the
number of earlier conditions on its row, and the conditions of one level,
on distinct rows, update at once, which gives the loop's sums in its order.
The 1:1 pairings run in one level; the physical-edge pairing maps several
disk rows onto one shell row once the disk is refined (``shared_targets``;
up to 108 levels on the kozlov L3 mesh).  theta_i is the scalar
``tilt_thetaB_value`` with ``rim_slope_match_thetaB_param`` set or without
a disk group, else the disk ring's radial tilt: paired 1:1 when the disk
and rim rings have equal counts (``local_disk``), else their arc-length
mean.  The in-rows of the tilt KKT projection subtract the disk-side term
in the same way: the paired disk row's direction, or a rank-1 background
(the arc-length-mean disk field) shared by every in-row; the disk-targeted
in-rows touch the disk row alone.  A lane without a disk group has
out-conditions only.  An unknown mode raises the JAX package's ValueError.

Sums over vertex rows: every scatter here writes rows that are distinct
within one call (the rim, outer and disk rings are disjoint groups, the
staggered enforcement writes distinct rows per update, the trace-shell
projection adds a shared row's values in the JAX package's order through
``state.ordered_index_add``), so an ``index_add`` adds at most one value
into a row; the KKT projector sums the slot rows in a fixed order
(``vertex_sum.row_sum``).  The whole-array float sums (arc lengths, ring
averages, the disk ring's mean) add through ``device/reduce.tree_sum``, so
a parameter-sweep member gets its single call's bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.reduce import tree_sum
from membrane_solver_tpu_torch.device.state import (
    check_unique_rows,
    occurrence_levels,
    ordered_index_add,
)
from membrane_solver_tpu_torch.energy import param

_KEY = "constraint:rim_slope_match_out"
_PHYSICAL = "physical_edge_staggered_v1"
_MODES = ("pointwise_radial_v1", "ring_average_radial_v1", "shared_rim_staggered_v1", _PHYSICAL)


def _tiny(dtype) -> float:
    return 1e-300 if dtype == torch.float64 else 1e-30


def _fmax_tiny(x):
    return torch.clamp(x, min=_tiny(x.dtype))


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


def _mode(gp) -> str:
    return str(gp.get("rim_slope_match_mode") or "pointwise_radial_v1").lower()


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(
            "rim_slope_match_mode must be 'pointwise_radial_v1' or "
            "'ring_average_radial_v1' or 'shared_rim_staggered_v1' or "
            "'physical_edge_staggered_v1'."
        )


def _scaffold_mesh_op_mode(gp) -> str:
    """The scaffold lane's projection in mesh-operation and finalize contexts."""
    mode = str(gp.get("rim_slope_match_scaffold_mesh_operation_mode") or "project")
    mode = mode.strip().lower()
    if mode not in {"project", "preserve_trace_v1"}:
        raise ValueError(
            "rim_slope_match_scaffold_mesh_operation_mode must be "
            "'project' or 'preserve_trace_v1'."
        )
    return mode


def _shells(layout):
    """The physical-edge local shells about the disk group (else the rim group), or None."""
    from membrane_solver_tpu_torch.constraints.local_interface_shells import build_shell_rows

    gp = layout.mesh.global_parameters
    group = gp.get("rim_slope_match_disk_group") or gp.get("rim_slope_match_group")
    if group is None:
        return None
    shells = build_shell_rows(layout, group=str(group))
    if shells is None or shells.disk_rows.size == 0:
        return None
    return shells


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
    """Flags (active, has_disk, interp_outer, local_disk, theta_is_param, staggered,
    disk_targeting, ring_average, scaffold, mesh_op_mode, projector_mode, has_trace[,
    shared_targets]).

    The JAX module's tuple.  In the physical-edge mode ``scaffold`` is
    ``parity_trace_layer_radius`` set with ``parity_outer_shells`` > 0 (theta
    from the disk rows, no disk targeting), ``has_trace`` the radius alone,
    and ``shared_targets`` says that several conditions share a shell row.
    """
    gp = layout.mesh.global_parameters
    mode = _mode(gp)  # checked by compile_topology, the hook that runs first
    if mode == _PHYSICAL:
        shells = _shells(layout)
        if shells is None:
            return ("inactive",)
        has_trace = gp.get("parity_trace_layer_radius") is not None
        scaffold = has_trace and int(gp.get("parity_outer_shells") or 0) > 0
        matched = np.asarray(shells.rim_rows_for_disk)
        return (
            "active",
            True,   # has_disk: the disk group is the matching's rim
            False,  # the shells pair by azimuth, no interpolation
            True,   # local_disk
            (gp.get("rim_slope_match_thetaB_param") is not None) and not scaffold,
            True,   # staggered
            not scaffold,  # disk_targeting
            False,  # ring_average
            scaffold,
            _scaffold_mesh_op_mode(gp),
            str(gp.get("rim_slope_match_scaffold_projector_mode") or "").strip().lower(),
            has_trace,
            bool(len(np.unique(matched)) != len(matched)),
        )
    rings = _rings(layout)
    if rings is None:
        return ("inactive",)
    rim, outer, disk = rings
    return (
        "active",
        bool(disk),
        len(outer) != len(rim),
        bool(disk) and len(disk) == len(rim),
        gp.get("rim_slope_match_thetaB_param") is not None,
        mode == "shared_rim_staggered_v1",
        False,      # disk_targeting
        mode == "ring_average_radial_v1",
        False,      # scaffold
        "project",  # mesh_op_mode
        "",         # projector_mode
        False,      # has_trace
    )


def _ring(rows):
    return (np.asarray(rows or [0], dtype=np.int64),
            np.ones(len(rows), dtype=bool) if rows else np.zeros(1, dtype=bool))


def compile_topology(layout) -> dict:
    gp = layout.mesh.global_parameters
    _check_mode(_mode(gp))
    center = np.asarray(gp.get("rim_slope_match_center") or [0, 0, 0], dtype=float)
    normal = np.asarray(gp.get("rim_slope_match_normal") or [0, 0, 1], dtype=float)
    normal /= max(np.linalg.norm(normal), 1e-15)

    if _mode(gp) == _PHYSICAL:
        # the disk group (in azimuth order) is the matching's rim and its own
        # disk ring; each row's outer row is the shell row nearest in azimuth
        # (shared by several disk rows once the disk is refined)
        shells = _shells(layout)
        rim = [] if shells is None else [int(r) for r in shells.disk_rows]
        outer = [] if shells is None else [int(r) for r in shells.rim_rows_for_disk]
        check_unique_rows(rim, "rim_slope_match_out disk rows")
        rim_arr, rim_valid = _ring(rim)
        outer_arr, outer_valid = _ring(outer)
        out = {"rim": rim_arr, "outer": outer_arr, "disk": rim_arr, "valid": rim_valid,
               "outer_valid": outer_valid, "disk_valid": rim_valid, "center": center,
               "normal": normal}
        if shells is not None:
            out["shell_radii"] = np.asarray(
                [shells.disk_radius, shells.rim_radius, shells.outer_radius])
        return out

    def ring(rows):
        return _ring(_order_ring(layout, rows, center, normal) if rows else [])

    rim, outer, disk = _rings(layout) or ([], [], [])
    # the rim, outer and disk rows are distinct, so each index_add below adds
    # one value per row (exact in any order)
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


def _x(topo, key, prefix=_KEY):
    return topo.extras[f"{prefix}/{key}"]


@dataclasses.dataclass(frozen=True)
class Flags:
    """The compiled mode flags a hook needs."""

    has_disk: bool
    interp_outer: bool
    local_disk: bool
    theta_is_param: bool
    staggered: bool
    ring_average: bool
    disk_targeting: bool = False
    scaffold: bool = False
    mesh_op_mode: str = "project"
    projector_mode: str = ""
    has_trace: bool = False
    shared_targets: bool = False

    @property
    def theta_scalar(self) -> bool:
        return self.theta_is_param or not self.has_disk


def _spec_flags(spec, key=_KEY):
    """The :class:`Flags` of an active lane, else None (``key``: the extras prefix)."""
    f = spec.static_of(key, ("inactive",))
    if f[0] != "active":
        return None
    return Flags(bool(f[1]), bool(f[2]), bool(f[3]), bool(f[4]), bool(f[5]), bool(f[7]),
                 bool(f[6]), bool(f[8]), str(f[9]), str(f[10]), bool(f[11]),
                 len(f) > 12 and bool(f[12]))


def _ring_neighbors(k, live, device):
    idx = torch.arange(k, device=device)
    n_live = torch.sum(live.to(torch.int64))
    nxt = torch.where(idx + 1 >= n_live, 0, idx + 1)
    prv = torch.where(idx - 1 < 0, n_live - 1, idx - 1)
    return idx, n_live, nxt, prv


def _ring_weights(pos, live):
    """Arc-length weights 0.5 (|p_next - p| + |p - p_prev|) on a closed ring."""
    _idx, _n, nxt, prv = _ring_neighbors(pos.shape[0], live, pos.device)
    l_next = torch.linalg.vector_norm(pos[nxt] - pos, dim=1)
    l_prev = torch.linalg.vector_norm(pos - pos[prv], dim=1)
    return 0.5 * (l_next + l_prev)


def _ring_arc_params(pos, valid):
    """(normalized arc-length parameter per ring vertex, ring length)."""
    idx, n_live, nxt, _prv = _ring_neighbors(pos.shape[0], valid, pos.device)
    seg = torch.where(idx < n_live, torch.linalg.vector_norm(pos[nxt] - pos, dim=1), 0.0)
    total = tree_sum(seg)
    s = torch.cat([seg.new_zeros((1,)), torch.cumsum(seg, dim=0)[:-1]])
    return s / _fmax_tiny(total), total


def _interp_ring(outer_pos, outer_valid, s_targets):
    """(idx0, idx1, w0, w1): the outer ring sampled at the arc-length parameters ``s_targets``."""
    s_out, _total = _ring_arc_params(outer_pos, outer_valid)
    k = outer_pos.shape[0]
    n_live = torch.sum(outer_valid.to(torch.int64))
    # push padded entries past any target in [0, 1)
    s_sorted = torch.where(torch.arange(k, device=outer_pos.device) < n_live, s_out, 2.0)
    idx1_raw = torch.searchsorted(s_sorted, s_targets, right=True)
    n_mod = torch.clamp(n_live, min=1)
    idx1 = idx1_raw % n_mod
    idx0 = (idx1_raw - 1) % n_mod
    s0 = s_out[idx0]
    s1 = s_out[idx1]
    s1_adj = torch.where(s1 <= s0, s1 + 1.0, s1)
    st_adj = torch.where(s_targets < s0, s_targets + 1.0, s_targets)
    denom = s1_adj - s0
    t = torch.where(denom > 1e-12, (st_adj - s0) / torch.clamp(denom, min=1e-12), 0.0)
    return idx0, idx1, 1.0 - t, t


def matching_data(positions, topo, interp_outer: bool, prefix=_KEY):
    """Live matching payload (valid, phi, inv_dr, r_hat, weights, normal, outer map).

    Recomputed from the current positions at every evaluation.  The outer
    map (idx0, idx1, w0, w1) pairs each rim vertex with the outer ring: 1:1
    on equal rings, by normalized arc length otherwise.  ``prefix`` names
    the extras (the soft energy's own, ``energy:rim_slope_match_out``).
    """
    dtype = positions.dtype
    rim = _x(topo, "rim", prefix)
    outer = _x(topo, "outer", prefix)
    ring_valid = _x(topo, "valid", prefix)
    center = _x(topo, "center", prefix).to(dtype)
    normal = _x(topo, "normal", prefix).to(dtype)

    rim_pos = positions[rim]
    rel = rim_pos - center
    rel_p = rel - torch.sum(rel * normal, dim=1, keepdim=True) * normal
    r_len = torch.linalg.vector_norm(rel_p, dim=1)
    good = ring_valid & (r_len > 1e-12)
    r_hat = torch.where(good[:, None], rel_p / torch.clamp(r_len, min=1e-12)[:, None], 0.0)

    k = rim.shape[0]
    if interp_outer:
        s_rim, _ = _ring_arc_params(rim_pos, ring_valid)
        idx0, idx1, w0, w1 = _interp_ring(positions[outer], _x(topo, "outer_valid", prefix), s_rim)
        outer_pos = w0[:, None] * positions[outer[idx0]] + w1[:, None] * positions[outer[idx1]]
    else:
        idx0 = idx1 = torch.arange(k, device=rim.device)
        w0 = positions.new_ones((k,))
        w1 = positions.new_zeros((k,))
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
    return valid, phi, inv_dr, r_hat, weights, normal, (idx0, idx1, w0, w1)


def _tangent_radial(r_hat, vnormals, rows):
    n = vnormals[rows]
    r_dir = r_hat - torch.sum(r_hat * n, dim=1, keepdim=True) * n
    norm = torch.linalg.vector_norm(r_dir, dim=1)
    ok = norm > 1e-12
    return torch.where(ok[:, None], r_dir / torch.clamp(norm, min=1e-12)[:, None], 0.0), ok


def _staggered_targets(topo, r_hat, vnormals, omap):
    """(row0, row1, w0, w1, r_dir, ok, denom): the staggered conditions' target slots.

    Per rim index i the conditions act on the outer rows (outer[idx0],
    outer[idx1]) with weights (w0, w1); r_dir is r_hat tangent-projected
    with the weight-blended unit normal of those rows; denom = w0^2 + w1^2.
    """
    outer = _x(topo, "outer")
    idx0, idx1, w0, w1 = omap
    row0 = outer[idx0]
    row1 = outer[idx1]
    n = w0[:, None] * vnormals[row0] + w1[:, None] * vnormals[row1]
    nn = torch.linalg.vector_norm(n, dim=1)
    ok_n = nn > 1e-12
    n = torch.where(ok_n[:, None], n / torch.clamp(nn, min=1e-12)[:, None], 0.0)
    r_dir = r_hat - torch.sum(r_hat * n, dim=1, keepdim=True) * n
    rn = torch.linalg.vector_norm(r_dir, dim=1)
    ok = ok_n & (rn > 1e-12)
    r_dir = torch.where(ok[:, None], r_dir / torch.clamp(rn, min=1e-12)[:, None], 0.0)
    return row0, row1, w0, w1, r_dir, ok, w0 * w0 + w1 * w1


def ordered_rows(topo) -> dict:
    """{key: rows} of this module's ``ordered_index_add`` calls and condition levels (the
    parameter sweep builds their levels before it maps the members)."""
    if f"{_KEY}/outer" not in topo.extras:
        return {}
    return {_KEY + "/outer": topo.extras[f"{_KEY}/outer"]}


def _condition_levels(topo, rows):
    """The conditions in levels of distinct target rows, as index tensors (kept per topology).

    A condition's level is the number of earlier conditions on its row, so
    a row's conditions run in their order, one level after the other.
    ``rows`` are the outer rows in condition order (the pairing without
    interpolation), so the levels are those of ``state.ordered_index_add``'s
    key for the outer rows, kept once for both (:func:`ordered_rows`).
    """

    return topo.kept(("ordered_index_add", _KEY + "/outer"), lambda: occurrence_levels(rows))


def _staggered_enforce_fields(fields, fr, oks, targets, flags: Flags, topo):
    """Enforce sum_k w_k (t[row_k] . r_dir) = target per condition on each tilt field.

    One condition after the other, each seeing the earlier updates, as the
    reference's loop does.  The pairing without interpolation (one row per
    condition, weight 1, the rows fixed per topology) runs in levels of
    distinct rows (:func:`_condition_levels`), all fields together: one
    level when no row is shared.  The interpolated pairing, whose rows
    follow the positions, runs the conditions one at a time.  No
    physical-edge lane reaches that loop (its shells pair by azimuth,
    ``interp_outer`` is False), so the parameter sweep's physical-edge and
    scaffold lanes run the levels alone.
    """
    row0, row1, w0, w1, r_dir, denom = (fr[k] for k in ("row0", "row1", "w0", "w1", "r_dir",
                                                         "denom"))
    safe = torch.clamp(denom, min=1e-12)
    if not flags.interp_outer:
        # row1 is row0 with weight 0 here: its term and its update are zero
        t = torch.stack(fields)
        ok, target = torch.stack(oks), torch.stack(targets)
        for idx in _condition_levels(topo, row0):
            rows, rd = row0[idx], r_dir[idx]
            t_rad = w0[idx] * torch.sum(t[:, rows] * rd, dim=2)
            delta = torch.where(ok[:, idx], target[:, idx] - t_rad, 0.0)
            t = t.index_add(1, rows, (delta * w0[idx] / safe[idx])[:, :, None] * rd)
        return list(t.unbind(0))
    out = []
    for tilts, ok, target in zip(fields, oks, targets):
        for i in range(row0.shape[0]):
            r0, r1 = row0[i:i + 1], row1[i:i + 1]
            a0, a1, rd, sf = w0[i], w1[i], r_dir[i:i + 1], safe[i]
            t_rad = a0 * torch.sum(tilts[r0] * rd) + a1 * torch.sum(tilts[r1] * rd)
            delta = torch.where(ok[i], target[i] - t_rad, 0.0)
            tilts = tilts.index_add(0, r0, (delta * a0 / sf) * rd)
            tilts = tilts.index_add(0, r1, torch.where(a1 != 0.0, delta * a1 / sf, 0.0) * rd)
        out.append(tilts)
    return out


def _disk_geometry(positions, topo, prefix=_KEY):
    """(disk rows, valid, r_hat, arc-length weights) for the disk ring."""
    dtype = positions.dtype
    disk = _x(topo, "disk", prefix)
    disk_valid = _x(topo, "disk_valid", prefix)
    center = _x(topo, "center", prefix).to(dtype)
    normal = _x(topo, "normal", prefix).to(dtype)
    disk_pos = positions[disk]
    rel = disk_pos - center
    rel_p = rel - torch.sum(rel * normal, dim=1, keepdim=True) * normal
    dlen = torch.linalg.vector_norm(rel_p, dim=1)
    good = disk_valid & (dlen > 1e-12)
    disk_r_hat = torch.where(good[:, None], rel_p / torch.clamp(dlen, min=1e-12)[:, None], 0.0)
    w = torch.where(good, _ring_weights(disk_pos, disk_valid), 0.0)
    return disk, good, disk_r_hat, w


def _ring_average_delta(ok, coeff, target, t_rad):
    """The scalar averaged residual sum coeff (target - t_rad) / sum coeff."""
    c = torch.where(ok, coeff, 0.0)
    den = tree_sum(c)
    num = tree_sum(c * (target - t_rad))
    return torch.where(den > 0.0, num / _fmax_tiny(den), 0.0)


def _vertex_normals(positions, topo):
    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    return dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())


def _payload(flags: Flags, positions, topo):
    """The position-only part of the tilt enforcement, computed once per relax call."""
    valid, phi, _inv_dr, r_hat, ring_w, _normal, omap = matching_data(
        positions, topo, flags.interp_outer)
    rim = _x(topo, "rim")
    vnormals = _vertex_normals(positions, topo)
    fi, fo = topo.tilt_fixed_in_mask, topo.tilt_fixed_out_mask
    if flags.staggered:
        row0, row1, w0, w1, r_dir, dir_ok, denom = _staggered_targets(topo, r_hat, vnormals, omap)
        use = valid & dir_ok
        second = (row1 != row0) | (w1 != 0.0)
        fr = {"phi": phi, "row0": row0, "row1": row1, "w0": w0, "w1": w1, "denom": denom,
              "r_dir": r_dir, "ok_out": use & ~(fo[row0] | (fo[row1] & second)),
              "ok_in": use & ~(fi[row0] | (fi[row1] & second))}
        if flags.disk_targeting:
            # the inner condition on the disk row itself, along the planar radial
            fr.update(rim=rim, r_hat=r_hat, ok_in=use & ~fi[rim])
    else:
        r_dir, dir_ok = _tangent_radial(r_hat, vnormals, rim)
        use = valid & dir_ok
        fr = {"rim": rim, "phi": phi, "r_dir": r_dir,
              "coeff": torch.sqrt(torch.clamp(ring_w, min=0.0)),
              "ok_out": use & ~fo[rim], "ok_in": use & ~fi[rim]}
    if not flags.theta_scalar:
        disk, dgood, disk_r_hat, dw = _disk_geometry(positions, topo)
        fr.update(disk=disk, dgood=dgood, disk_r_hat=disk_r_hat, dw=dw)
    return fr


def _theta(flags: Flags, tin, fr, params, phi):
    """Per-condition theta target: the scalar theta_B, or the disk ring's radial tilt."""
    if flags.theta_scalar:
        return param(params, "tilt_thetaB_value", like=phi).expand_as(phi)
    theta_vals = torch.sum(tin[fr["disk"]] * fr["disk_r_hat"], dim=1)
    if flags.local_disk:
        return theta_vals
    wsum = tree_sum(torch.where(fr["dgood"], fr["dw"], 0.0))
    mean = tree_sum(torch.where(fr["dgood"], fr["dw"] * theta_vals, 0.0)) / _fmax_tiny(wsum)
    return mean.expand_as(phi)


def _apply(flags: Flags, tin, tout, fr, params, topo):
    """Project the outer, then the inner matching condition: (tin, tout)."""
    phi, r_dir = fr["phi"], fr["r_dir"]
    if flags.staggered:
        # theta reads the disk rows, which no staggered condition writes
        theta = _theta(flags, tin, fr, params, phi)
        if flags.disk_targeting:
            (tout,) = _staggered_enforce_fields([tout], fr, [fr["ok_out"]], [phi], flags, topo)
            rim, r_hat = fr["rim"], fr["r_hat"]
            t_in_rad = torch.sum(tin[rim] * r_hat, dim=1)
            delta_in = torch.where(fr["ok_in"], (theta - phi) - t_in_rad, 0.0)
            return tin.index_add(0, rim, delta_in[:, None] * r_hat), tout
        tout, tin = _staggered_enforce_fields(
            [tout, tin], fr, [fr["ok_out"], fr["ok_in"]], [phi, theta - phi], flags, topo)
        return tin, tout
    rim = fr["rim"]
    ok_out, ok_in = fr["ok_out"], fr["ok_in"]
    t_out_rad = torch.sum(tout[rim] * r_dir, dim=1)
    if flags.ring_average:
        delta_out = torch.where(ok_out, _ring_average_delta(ok_out, fr["coeff"], phi, t_out_rad),
                                0.0)
    else:
        delta_out = torch.where(ok_out, phi - t_out_rad, 0.0)
    tout = tout.index_add(0, rim, delta_out[:, None] * r_dir)
    theta = _theta(flags, tin, fr, params, phi)
    t_in_rad = torch.sum(tin[rim] * r_dir, dim=1)
    if flags.ring_average:
        delta_in = torch.where(
            ok_in, _ring_average_delta(ok_in, fr["coeff"], theta - phi, t_in_rad), 0.0)
    else:
        delta_in = torch.where(ok_in, (theta - phi) - t_in_rad, 0.0)
    return tin.index_add(0, rim, delta_in[:, None] * r_dir), tout


def make_enforce_tilts(spec):
    flags = _spec_flags(spec)
    if flags is None:
        return None

    def enforce(state, topo, params):
        fr = _payload(flags, state.positions, topo)
        tin, tout = _apply(flags, state.tilts_in, state.tilts_out, fr, params, topo)
        return dataclasses.replace(state, tilts_in=tin, tilts_out=tout)

    return enforce


def make_frozen_enforce_tilts(spec):
    """Frozen split of :func:`make_enforce_tilts` (positions constant)."""
    flags = _spec_flags(spec)
    if flags is None:
        return None

    def precompute(state, topo, params):
        return _payload(flags, state.positions, topo)

    def enforce(tin, tout, fr, topo, params):
        return _apply(flags, tin, tout, fr, params, topo)

    return precompute, enforce


def make_enforce(spec):
    """Trace-shell height and outer tilt projection of the physical-edge trace lanes, or None.

    With ``parity_trace_layer_radius`` set: each condition's target slope
    phi* and outer radial tilt t* come from a joint local proximal solve
    (equal weights on staying near the current slope and outer tilt and on
    t_out = phi, t_in = theta - phi), or under the ``continuity_v2``
    projector mode phi* = t* = theta / 2.  Each shell row moves along the
    lane normal to the mean of its conditions' target heights h_rim + phi*
    dr, and its outer tilt's planar-radial part (tangent-projected with the
    vertex normals before the move) becomes the mean t*.  A shell row's
    conditions add in the JAX package's order (``state.ordered_index_add``).
    Skipped in mesh-operation and finalize contexts on the scaffold lane
    under ``preserve_trace_v1``.  None in the other modes, which have no
    geometric enforcement.
    """
    flags = _spec_flags(spec)
    if flags is None or not (flags.staggered and flags.has_trace):
        return None

    def enforce(state, topo, params, context="minimize"):
        if (context in {"mesh_operation", "finalize"} and flags.scaffold
                and flags.mesh_op_mode == "preserve_trace_v1"):
            return state
        positions = state.positions
        valid, phi, inv_dr, r_hat, _w, normal, omap = matching_data(
            positions, topo, flags.interp_outer)
        rim, outer = _x(topo, "rim"), _x(topo, "outer")
        n_rows = positions.shape[0]
        vnormals = _vertex_normals(positions, topo)
        row0, row1, sw0, sw1, r_dir, dir_ok, _denom = _staggered_targets(topo, r_hat, vnormals,
                                                                        omap)
        tin, tout = state.tilts_in, state.tilts_out
        t_out_rad = sw0 * torch.sum(tout[row0] * r_dir, dim=1) + sw1 * torch.sum(
            tout[row1] * r_dir, dim=1)
        t_in_rad = sw0 * torch.sum(tin[row0] * r_dir, dim=1) + sw1 * torch.sum(
            tin[row1] * r_dir, dim=1)
        fr = {}
        if not flags.theta_scalar:
            disk, dgood, disk_r_hat, dw = _disk_geometry(positions, topo)
            fr.update(disk=disk, dgood=dgood, disk_r_hat=disk_r_hat, dw=dw)
        theta = _theta(flags, tin, fr, params, phi)
        continuity = theta - t_in_rad

        ok = valid & dir_ok & (torch.abs(inv_dr) > 1e-12)
        dr = torch.where(ok, 1.0 / torch.where(ok, inv_dr, 1.0), 0.0)
        if flags.projector_mode == "continuity_v2":
            phi_target = 0.5 * theta
            t_out_target = phi_target
        else:
            phi_target = (2.0 * phi + t_out_rad + 2.0 * continuity) / 5.0
            t_out_target = 0.5 * (phi_target + t_out_rad)
        target_h = positions[rim] @ normal + phi_target * dr

        # the pairing is azimuthal (no interpolation): each condition has
        # the one shell row outer[i] with weight 1
        zeros = positions.new_zeros((n_rows,))

        def shell_sum(values):
            return ordered_index_add(topo, _KEY + "/outer", zeros, outer,
                                     torch.where(ok, values, 0.0))

        h_num = shell_sum(target_h)
        h_den = shell_sum(torch.ones_like(target_h))
        t_num = shell_sum(t_out_target)
        move = (h_den > 1e-12) & ~topo.fixed_mask
        cur_h = positions @ normal
        target_mean = h_num / _fmax_tiny(h_den)
        new_positions = torch.where(
            move[:, None], positions + (target_mean - cur_h)[:, None] * normal[None, :], positions)

        # the outer radial tilt on the moved positions, with the normals of
        # the positions before the move
        xy = new_positions[:, :2]
        radius = torch.linalg.vector_norm(xy, dim=1)
        r_ok = radius > 1e-12
        r_hat_row = torch.where(
            r_ok[:, None], torch.cat([xy / _fmax_tiny(radius)[:, None], zeros[:, None]], dim=1),
            0.0)
        rd = r_hat_row - torch.sum(r_hat_row * vnormals, dim=1)[:, None] * vnormals
        rd_n = torch.linalg.vector_norm(rd, dim=1)
        rd_ok = rd_n > 1e-12
        rd = torch.where(rd_ok[:, None], rd / _fmax_tiny(rd_n)[:, None], 0.0)
        upd = (h_den > 1e-12) & ~topo.tilt_fixed_out_mask & r_ok & rd_ok
        radial = torch.sum(tout * rd, dim=1)
        new_tout = torch.where(
            upd[:, None], tout + (t_num / _fmax_tiny(h_den) - radial)[:, None] * rd, tout)
        return dataclasses.replace(state, positions=new_positions, tilts_out=new_tout)

    return enforce


def _mean_disk_field(disk, dgood, disk_r_hat, dw, n_rows):
    """(Nv, 3) arc-length-mean disk direction field shared by every in-row."""
    wsum = tree_sum(torch.where(dgood, dw, 0.0))
    mean_dirs = (dw / _fmax_tiny(wsum))[:, None] * disk_r_hat
    return disk_r_hat.new_zeros((n_rows, 3)).index_add(
        0, disk, torch.where(dgood[:, None], mean_dirs, 0.0)
    )


def _tilt_row_data(flags: Flags, positions, topo):
    """(coeff, r_dir, targets, use, r_hat): the tilt rows' values and slots per condition.

    ``targets`` lists (rows, weight) pairs: [(row0, w0), (row1, w1)]
    (staggered) or [(rim, None)]; ``r_hat`` is the planar radial of the
    disk-targeted in-rows.
    """
    valid, _phi, _inv_dr, r_hat, weights, _normal, omap = matching_data(
        positions, topo, flags.interp_outer)
    vnormals = _vertex_normals(positions, topo)
    if flags.staggered:
        row0, row1, w0, w1, r_dir, dir_ok, _denom = _staggered_targets(
            topo, r_hat, vnormals, omap)
        targets = [(row0, w0), (row1, w1)]
    else:
        rim = _x(topo, "rim")
        r_dir, dir_ok = _tangent_radial(r_hat, vnormals, rim)
        targets = [(rim, None)]
    use = valid & dir_ok
    coeff = torch.where(use, torch.sqrt(torch.clamp(weights, min=0.0)), 0.0)
    return coeff, r_dir, targets, use, r_hat


def make_tilt_constraint_rows(spec):
    """Dense (k, 2, Nv, 3) (in, out) tilt rows: the out rows, then the in rows.

    One row pair per condition, or one per leaflet family in the ring-average
    mode.  The relax takes these only when a module's rows have no compact
    form (:func:`make_compact_tilt_rows`: the ring-average mode).
    """
    flags = _spec_flags(spec)
    if flags is None:
        return lambda state, topo, params: None

    def fn(state, topo, params):
        positions = state.positions
        coeff, r_dir, targets, _use, r_hat = _tilt_row_data(flags, positions, topo)
        k = coeff.shape[0]
        n_rows = positions.shape[0]
        idx = torch.arange(k, device=positions.device)

        def base_row():
            g = positions.new_zeros((k, n_rows, 3))
            for rows, w in targets:
                c = coeff if w is None else coeff * w
                g = g.index_put((idx, rows), c[:, None] * r_dir, accumulate=True)
            return g

        def agg(pairs):
            return torch.sum(pairs, dim=0, keepdim=True) if flags.ring_average else pairs

        zeros = positions.new_zeros((k, n_rows, 3))
        out_pairs = agg(torch.stack([zeros, base_row()], dim=1))
        if not flags.has_disk:
            return out_pairs
        if flags.disk_targeting:
            # the physical-edge in-rows: coeff * planar r_hat at the disk row only
            gin = zeros.index_put((idx, _x(topo, "rim")), coeff[:, None] * r_hat,
                                  accumulate=True)
            return torch.cat([out_pairs, agg(torch.stack([gin, zeros], dim=1))])
        disk, dgood, disk_r_hat, dw = _disk_geometry(positions, topo)
        gin = base_row()
        if flags.local_disk:
            gin = gin.index_put((idx, disk), -coeff[:, None] * disk_r_hat, accumulate=True)
        else:
            shared = _mean_disk_field(disk, dgood, disk_r_hat, dw, n_rows)
            gin = gin - coeff[:, None, None] * shared[None, :, :]
        return torch.cat([out_pairs, agg(torch.stack([gin, zeros], dim=1))])

    return fn


def make_compact_tilt_rows(spec):
    """Compact tilt rows: (values (k, s, 3), rows (k, s), leaflet (k, s)[, bg_coeff, bg_field]).

    Out rows touch the condition's target slots on the out leaflet; in rows
    the same slots on the in leaflet plus the paired (disk, in) slot (local
    disk), or a rank-1 background, the arc-length-mean disk field shared by
    every in row; disk-targeted in rows the disk row alone.  Without a disk
    group, out rows only.  None in the
    ring-average mode, whose aggregate rows touch the whole ring.
    """
    flags = _spec_flags(spec)
    if flags is None:
        return lambda state, topo, params: None
    if flags.ring_average:
        return None

    def fn(state, topo, params):
        positions = state.positions
        coeff, r_dir, targets, use, r_hat = _tilt_row_data(flags, positions, topo)
        k = coeff.shape[0]
        base_vals = [(coeff if w is None else coeff * w)[:, None] * r_dir for _r, w in targets]
        base_rows = [torch.where(use, rows, 0) for rows, _w in targets]
        n_base = len(base_vals)
        zero_val = positions.new_zeros((k, 3))
        zero_row = torch.zeros_like(base_rows[0])
        out_vals = torch.stack(base_vals + [zero_val], dim=1)
        out_rows = torch.stack(base_rows + [zero_row], dim=1)
        out_leaf = torch.ones_like(out_rows)
        if not flags.has_disk:
            return out_vals[:, :n_base], out_rows[:, :n_base], out_leaf[:, :n_base]
        if flags.disk_targeting:
            # one slot: coeff * planar r_hat at the disk row, inner leaflet
            in_vals = torch.stack([coeff[:, None] * r_hat] + [zero_val] * n_base, dim=1)
            in_rows = torch.stack([torch.where(use, _x(topo, "rim"), 0)] + [zero_row] * n_base,
                                  dim=1)
            return (torch.cat([out_vals, in_vals]), torch.cat([out_rows, in_rows]),
                    torch.cat([out_leaf, torch.zeros_like(in_rows)]))
        disk, dgood, disk_r_hat, dw = _disk_geometry(positions, topo)
        if flags.local_disk:
            in_vals = torch.stack(
                base_vals + [torch.where(dgood[:, None], -coeff[:, None] * disk_r_hat, 0.0)],
                dim=1)
            in_rows = torch.stack(base_rows + [torch.where(dgood, disk, 0)], dim=1)
            return (torch.cat([out_vals, in_vals]), torch.cat([out_rows, in_rows]),
                    torch.cat([out_leaf, torch.zeros_like(in_rows)]))
        shared_in = _mean_disk_field(disk, dgood, disk_r_hat, dw, positions.shape[0])
        bg_field = torch.stack([shared_in, torch.zeros_like(shared_in)])  # (2, Nv, 3)
        in_vals = torch.stack(base_vals, dim=1)
        in_rows = torch.stack(base_rows, dim=1)
        return (torch.cat([out_vals[:, :n_base], in_vals]),
                torch.cat([out_rows[:, :n_base], in_rows]),
                torch.cat([out_leaf[:, :n_base], torch.zeros_like(in_rows)]),
                torch.cat([coeff.new_zeros((k,)), -coeff]), bg_field)

    return fn


def _shape_rows(flags: Flags, positions, topo):
    """(slot rows (k, 3), slot coefficients (k, 3), valid, normal): one shape condition per rim vertex.

    Slots: the rim row (+coeff) and the two interpolated outer rows
    (-coeff w0, -coeff w1), coeff = sqrt(w_i) inv_dr_i (zero where ``valid`` is False).
    """
    valid, _phi, inv_dr, _r_hat, weights, normal, omap = matching_data(
        positions, topo, flags.interp_outer)
    idx0, idx1, w0, w1 = omap
    outer = _x(topo, "outer")
    coeff = torch.where(valid, torch.sqrt(torch.clamp(weights, min=0.0)) * inv_dr, 0.0)
    rows = torch.stack([_x(topo, "rim"), outer[idx0], outer[idx1]], dim=1)
    coeffs = torch.stack([coeff, -(coeff * w0), -(coeff * w1)], dim=1)
    return rows, coeffs, valid, normal


def make_constraint_gradient_rows(spec):
    """Dense shape KKT rows tying rim and outer heights, one per rim vertex (one in all, ring average).

    As in the JAX package, the in-condition rows (exact negations of the
    out rows) are dropped: same span, well-conditioned system.
    """
    flags = _spec_flags(spec)
    if flags is None:
        return lambda state, topo, params: None

    def fn(state, topo, params):
        positions = state.positions
        rows, coeffs, _valid, nvec = _shape_rows(flags, positions, topo)
        k = rows.shape[0]
        idx = torch.arange(k, device=rows.device)
        g = positions.new_zeros((k, positions.shape[0], 3))
        for j in range(3):
            g = g.index_put((idx, rows[:, j]), coeffs[:, j, None] * nvec, accumulate=True)
        return torch.sum(g, dim=0, keepdim=True) if flags.ring_average else g

    return fn


def make_compact_constraint_rows(spec):
    """Compact form of the shape rows: (values (K, s, 3), rows (K, s)), or None.

    The JAX module's three slots (rim, outer[idx0], outer[idx1]) when the
    outer ring is interpolated; with the 1:1 pairing the third slot carries
    zero and is left out.  Rows of a condition that this state leaves out
    carry zero values; the slots of a compiled-out ring entry aim at the
    last vertex row.  On the 1:1 pairing the rows are thus fixed per
    topology, and the KKT projector keeps their slot CSR (``fixed_rows``);
    the interpolated pairing follows the positions.  None in the
    ring-average mode (its one aggregate row is dense).
    """
    flags = _spec_flags(spec)
    if flags is None or flags.ring_average:
        return None
    n_slots = 3 if flags.interp_outer else 2

    def fn(state, topo, params):
        positions = state.positions
        rows, coeffs, valid, nvec = _shape_rows(flags, positions, topo)
        slot_vals = coeffs[:, :n_slots, None] * nvec
        slot_rows = torch.where(_x(topo, "valid")[:, None], rows[:, :n_slots],
                                positions.shape[0] - 1)
        return slot_vals, slot_rows

    fn.fixed_rows = not flags.interp_outer
    return fn
