"""Inner-leaflet disk contact driving term (Kozlov/Barnoy F_cont).

Counterpart of ``membrane_solver_tpu/energy/tilt_disk_contact_in.py``:

    F_cont = -2 pi R_eff gamma theta_B
    theta_B = arc-length-weighted mean of (t_in . r_hat) over the ring
    R_eff   = arc-length-weighted mean radius

over the vertices tagged ``rim_slope_match_group == group`` or
``tilt_disk_contact_group == group`` (group ``tilt_disk_contact_group_in``,
falling back to ``rim_slope_match_disk_group``), in the angular order fixed
when the problem is compiled.  gamma is ``tilt_disk_contact_strength_in`` or
the ``tilt_disk_contact_*`` contact parameters h * (delta_epsilon / a),
with the optional si-unit conversion, resolved on the host.  A work term
(``IS_EXTERNAL_WORK``: ``energy stats`` reports it apart): the exact tilt
gradient, positions detached.  The ring's weights and radii are those of
``tilt_thetaB_contact_in.ring_geometry``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from membrane_solver_tpu_torch.device.reduce import tree_sum
from membrane_solver_tpu_torch.energy import tilt_thetaB_contact_in as _contact

USES_TILT_LEAFLETS = True
IS_EXTERNAL_WORK = True

_PREFIX = "energy:tilt_disk_contact_in"


def _resolve_gamma(gp) -> float:
    val = gp.get("tilt_disk_contact_strength_in")
    if val is not None:
        return float(val or 0.0)

    def get_key(base):
        got = gp.get(f"{base}_in")
        return gp.get(base) if got is None else got

    h = get_key("tilt_disk_contact_h")
    if h is None:
        return 0.0
    over = get_key("tilt_disk_contact_delta_epsilon_over_a")
    if over is None:
        de = get_key("tilt_disk_contact_delta_epsilon")
        a = get_key("tilt_disk_contact_a")
        if de is None or a is None:
            return 0.0
        over = float(de) / float(a)
    raw = float(h) * float(over)
    units = str(gp.get("tilt_disk_contact_units") or "solver").strip().lower()
    if units in {"si", "physical", "physical_si"}:
        l0 = gp.get("tilt_disk_contact_length_unit_m")
        kref = gp.get("tilt_disk_contact_kappa_ref_J")
        if l0 is not None and kref is not None:
            l0, kref = float(l0), float(kref)
            if abs(l0) > 1e-30 and abs(kref) > 1e-30:
                return raw * l0 / kref
    return raw


def compile_topology(layout) -> dict:
    mesh = layout.mesh
    gp = mesh.global_parameters
    empty = {
        "rows": np.zeros(1, dtype=np.int64),
        "valid": np.zeros(1, dtype=bool),
        "center": np.zeros(3),
        "normal": np.array([0.0, 0.0, 1.0]),
        "has_normal": np.asarray(False),
        "gamma": np.asarray(0.0),
    }
    raw_group = gp.get("tilt_disk_contact_group_in") or gp.get("rim_slope_match_disk_group")
    if raw_group is None or not str(raw_group).strip():
        return empty
    group = str(raw_group).strip()
    rows = []
    for vid in sorted(mesh.vertices):
        opts = mesh.vertices[vid].options or {}
        if (opts.get("rim_slope_match_group") == group
                or opts.get("tilt_disk_contact_group") == group):
            rows.append(layout.row_of[int(vid)])
    if not rows:
        return empty
    center = np.asarray(gp.get("tilt_disk_contact_center") or [0, 0, 0], dtype=float)
    raw_n = gp.get("tilt_disk_contact_normal")
    if raw_n is not None:
        normal = np.asarray(raw_n, dtype=float).reshape(3)
        normal /= max(np.linalg.norm(normal), 1e-15)
    else:
        normal = np.array([0.0, 0.0, 1.0])
    out = _contact.ring_tables(layout, rows, center, normal, raw_n is not None)
    out["gamma"] = np.asarray(_resolve_gamma(gp))
    return out


def energy(geo, state, topo, params):
    tilts = state.tilts_in
    if f"{_PREFIX}/rows" not in topo.extras:
        return tilts.new_zeros(())
    rows = topo.extras[f"{_PREFIX}/rows"]
    gamma = params.get("tilt_disk_contact_strength_in",
                       topo.extras[f"{_PREFIX}/gamma"].to(tilts.dtype))
    _good, weights, r_hat, _r_len, wsum, r_eff = _contact.ring_geometry(
        state.positions.detach(), topo, _PREFIX, total=tree_sum)
    theta_vals = torch.sum(tilts[rows] * r_hat, dim=1)
    theta_B = tree_sum(weights * theta_vals) / torch.clamp(wsum, min=1e-12)
    return -2.0 * math.pi * r_eff * gamma * theta_B
