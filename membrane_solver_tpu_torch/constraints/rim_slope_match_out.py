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

When the rim and outer rings differ in size, the outer ring is sampled at
each rim vertex's normalized arc length (rows idx0, idx1 with weights
w0, w1), and the staggered enforcement runs the conditions one after the
other (adjacent conditions share a target row).  theta_i is the scalar
``tilt_thetaB_value`` with ``rim_slope_match_thetaB_param`` set or without
a disk group, else the disk ring's radial tilt: paired 1:1 when the disk
and rim rings have equal counts (``local_disk``), else their arc-length
mean.  The in-rows of the tilt KKT projection subtract the disk-side term
in the same way: the paired disk row's direction, or a rank-1 background
(the arc-length-mean disk field) shared by every in-row.  A lane without a
disk group has out-conditions only.  ``physical_edge_staggered_v1`` (the
local-shell placement) raises NotImplementedError when the problem is
compiled; an unknown mode raises the JAX package's ValueError.

Sums over vertex rows: every scatter here writes rows that are distinct
within one call (the rim, outer and disk rings are disjoint groups, the
sequential enforcement writes one row per update), so an ``index_add``
adds at most one value into a row; the KKT projector sums the slot rows
in a fixed order (``vertex_sum.row_sum``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.state import check_unique_rows
from membrane_solver_tpu_torch.energy import param

_KEY = "constraint:rim_slope_match_out"
_MODES = ("pointwise_radial_v1", "ring_average_radial_v1", "shared_rim_staggered_v1")


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
    if mode == "physical_edge_staggered_v1":
        raise NotImplementedError(
            "rim_slope_match_mode='physical_edge_staggered_v1' is not ported to "
            "membrane_solver_tpu_torch"
        )
    if mode not in _MODES:
        raise ValueError(
            "rim_slope_match_mode must be 'pointwise_radial_v1' or "
            "'ring_average_radial_v1' or 'shared_rim_staggered_v1' or "
            "'physical_edge_staggered_v1'."
        )


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
    disk_targeting, ring_average, scaffold, mesh_op_mode, projector_mode, has_trace).

    The JAX module's tuple; the last six belong to the physical-edge modes
    and keep their off values here.
    """
    gp = layout.mesh.global_parameters
    mode = _mode(gp)  # checked by compile_topology, the hook that runs first
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


def compile_topology(layout) -> dict:
    gp = layout.mesh.global_parameters
    _check_mode(_mode(gp))
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


def _x(topo, key):
    return topo.extras[f"{_KEY}/{key}"]


@dataclasses.dataclass(frozen=True)
class Flags:
    """The compiled mode flags a hook needs."""

    has_disk: bool
    interp_outer: bool
    local_disk: bool
    theta_is_param: bool
    staggered: bool
    ring_average: bool

    @property
    def theta_scalar(self) -> bool:
        return self.theta_is_param or not self.has_disk


def _spec_flags(spec):
    """The :class:`Flags` of an active lane, else None."""
    f = spec.static_of(_KEY, ("inactive",))
    if f[0] != "active":
        return None
    return Flags(bool(f[1]), bool(f[2]), bool(f[3]), bool(f[4]), bool(f[5]), bool(f[7]))


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
    total = torch.sum(seg)
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


def matching_data(positions, topo, interp_outer: bool):
    """Live matching payload (valid, phi, inv_dr, r_hat, weights, normal, outer map).

    Recomputed from the current positions at every evaluation.  The outer
    map (idx0, idx1, w0, w1) pairs each rim vertex with the outer ring: 1:1
    on equal rings, by normalized arc length otherwise.
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

    k = rim.shape[0]
    if interp_outer:
        s_rim, _ = _ring_arc_params(rim_pos, ring_valid)
        idx0, idx1, w0, w1 = _interp_ring(positions[outer], _x(topo, "outer_valid"), s_rim)
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


def _staggered_enforce_field(tilts, fr, ok, target, sequential: bool):
    """Enforce sum_k w_k (t[row_k] . r_dir) = target per condition.

    The distinct-row (1:1) form updates every condition at once; the
    ``sequential`` form (interpolated pairing, whose adjacent conditions
    share a row) updates one condition after the other, each seeing the
    earlier updates, as the reference's loop does.
    """
    row0, row1, w0, w1, r_dir, denom = (fr[k] for k in ("row0", "row1", "w0", "w1", "r_dir",
                                                         "denom"))
    if not sequential:
        t_rad = w0 * torch.sum(tilts[row0] * r_dir, dim=1) + w1 * torch.sum(
            tilts[row1] * r_dir, dim=1)
        delta = torch.where(ok, target - t_rad, 0.0)
        safe = torch.clamp(denom, min=1e-12)
        upd0 = (delta * w0 / safe)[:, None] * r_dir
        upd1 = (delta * w1 / safe)[:, None] * r_dir
        tilts = tilts.index_add(0, row0, upd0)
        return tilts.index_add(0, row1, torch.where((w1 != 0.0)[:, None], upd1, 0.0))
    for i in range(row0.shape[0]):
        r0, r1 = row0[i:i + 1], row1[i:i + 1]
        a0, a1, rd, den = w0[i], w1[i], r_dir[i:i + 1], denom[i]
        t_rad = a0 * torch.sum(tilts[r0] * rd) + a1 * torch.sum(tilts[r1] * rd)
        delta = torch.where(ok[i], target[i] - t_rad, 0.0)
        safe = torch.clamp(den, min=1e-12)
        tilts = tilts.index_add(0, r0, (delta * a0 / safe) * rd)
        tilts = tilts.index_add(0, r1, torch.where(a1 != 0.0, delta * a1 / safe, 0.0) * rd)
    return tilts


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


def _ring_average_delta(ok, coeff, target, t_rad):
    """The scalar averaged residual sum coeff (target - t_rad) / sum coeff."""
    c = torch.where(ok, coeff, 0.0)
    den = torch.sum(c)
    num = torch.sum(c * (target - t_rad))
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
    wsum = torch.sum(torch.where(fr["dgood"], fr["dw"], 0.0))
    mean = torch.sum(torch.where(fr["dgood"], fr["dw"] * theta_vals, 0.0)) / _fmax_tiny(wsum)
    return mean.expand_as(phi)


def _apply(flags: Flags, tin, tout, fr, params):
    """Project the outer, then the inner matching condition: (tin, tout)."""
    phi, r_dir = fr["phi"], fr["r_dir"]
    if flags.staggered:
        # interpolated targets are shared by adjacent conditions: sequential
        tout = _staggered_enforce_field(tout, fr, fr["ok_out"], phi, flags.interp_outer)
        theta = _theta(flags, tin, fr, params, phi)
        tin = _staggered_enforce_field(tin, fr, fr["ok_in"], theta - phi, flags.interp_outer)
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
        tin, tout = _apply(flags, state.tilts_in, state.tilts_out, fr, params)
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
        return _apply(flags, tin, tout, fr, params)

    return precompute, enforce


def make_enforce(spec):
    """Geometric enforcement: the JAX module projects heights only on the
    physical-edge trace lanes (not ported); the other modes have none."""
    return None


def _mean_disk_field(disk, dgood, disk_r_hat, dw, n_rows):
    """(Nv, 3) arc-length-mean disk direction field shared by every in-row."""
    wsum = torch.sum(torch.where(dgood, dw, 0.0))
    mean_dirs = (dw / _fmax_tiny(wsum))[:, None] * disk_r_hat
    return disk_r_hat.new_zeros((n_rows, 3)).index_add(
        0, disk, torch.where(dgood[:, None], mean_dirs, 0.0)
    )


def _tilt_row_data(flags: Flags, positions, topo):
    """(coeff, r_dir, targets, use): the tilt rows' values and slots per condition.

    ``targets`` lists (rows, weight) pairs: [(row0, w0), (row1, w1)]
    (staggered) or [(rim, None)].
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
    return coeff, r_dir, targets, use


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
        coeff, r_dir, targets, _use = _tilt_row_data(flags, positions, topo)
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
    every in row.  Without a disk group, out rows only.  None in the
    ring-average mode, whose aggregate rows touch the whole ring.
    """
    flags = _spec_flags(spec)
    if flags is None:
        return lambda state, topo, params: None
    if flags.ring_average:
        return None

    def fn(state, topo, params):
        positions = state.positions
        coeff, r_dir, targets, use = _tilt_row_data(flags, positions, topo)
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
