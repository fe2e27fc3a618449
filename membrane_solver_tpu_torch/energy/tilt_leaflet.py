"""Leaflet tilt magnitude energy core: E = 1/2 k_t sum_v |t_v|^2 A_v.

Counterpart of ``membrane_solver_tpu/energy/tilt_leaflet.py``: per-triangle
assembly E = sum coeff * A_tri with

    lumped (default):  coeff = 1/2 k (|t0|^2+|t1|^2+|t2|^2)/3
    consistent:        coeff = k/12 (|t0|^2+|t1|^2+|t2|^2 + t0.t1 + t1.t2 + t2.t0)

by ``tilt_mass_mode_<leaflet>`` (falling back to ``tilt_mass_mode``).  The
relax loop scores the lumped form whatever the mode, as in the JAX package.

Row weights w_v (``energy:tilt_<leaflet>/row_weights``) scale the tilts,
t_v -> w_v t_v, in the module energy only: the shared-rim weights (rows of
the ``rim`` group dropped from the inner leaflet, the outer shell's rows
dropped or scaled by sqrt(``tilt_in_shared_rim_outer_row_energy_weight``))
times the trace-layer weights of the physical-edge trace lanes (the trace
shell's rows at sqrt((r_trace - r_disk) / (r_outer - r_disk)), both
leaflets).  The relax loop's frozen and per-iteration energies stay
unweighted, as in the JAX package, whose relax descends a slightly
different objective from the score there.
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.energy import param
from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles

USES_TILT_LEAFLETS = True


def _flag(gp, *keys) -> bool:
    for k in keys:
        raw = gp.get(k)
        if raw is not None:
            if isinstance(raw, str):
                return raw.strip().lower() in {"1", "true", "yes", "on"}
            return bool(raw)
    return False


def compile_trace_layer_row_weights(layout):
    """The trace-layer row weights, or None.

    On the physical-edge trace lanes (``rim_slope_match_mode``
    ``physical_edge_staggered_v1``, ``parity_trace_layer_radius`` set and a
    non-empty ``theory_parity_lane``) the trace shell's rows carry
    sqrt((rim_r - disk_r) / (outer_r - disk_r)), clipped to [0, 1], and every
    other row 1.
    """
    gp = layout.mesh.global_parameters
    mode = str(gp.get("rim_slope_match_mode") or "").strip().lower()
    lane = str(gp.get("theory_parity_lane") or "").strip()
    if (mode != "physical_edge_staggered_v1" or gp.get("parity_trace_layer_radius") is None
            or not lane):
        return None
    from membrane_solver_tpu_torch.constraints.local_interface_shells import build_shell_rows

    shells = build_shell_rows(layout, group="disk")
    if shells is None:
        return None
    denom = float(shells.outer_radius) - float(shells.disk_radius)
    numer = float(shells.rim_radius) - float(shells.disk_radius)
    if denom <= 1e-12:
        return None
    frac = min(1.0, max(0.0, numer / denom))
    w = np.ones(len(layout.vertex_ids), dtype=float)
    w[np.asarray(shells.rim_rows, dtype=int)] = float(np.sqrt(frac))
    return w


def compile_shared_rim_row_weights(layout, leaflet: str):
    """The shared-rim row weights, or None.

    Rows of ``rim_slope_match_group`` ``rim`` weigh 0 under
    ``tilt_in_exclude_shared_rim_rows`` (inner leaflet); the outer shell's
    rows (tagged ``rim_slope_match_group`` ``outer``, else the first
    local-interface outer shell) weigh 0 under
    ``tilt_<leaflet>_exclude_shared_rim_outer_rows`` (or its aliases), else
    sqrt(``tilt_in_shared_rim_outer_row_energy_weight``) (inner leaflet).
    """
    gp = layout.mesh.global_parameters
    keys = [
        f"tilt_{leaflet}_exclude_shared_rim_outer_rows",
        f"tilt_exclude_shared_rim_outer_rows_{leaflet}",
    ]
    if leaflet == "out":
        keys += ["tilt_out_exclude_shared_rim_rows", "tilt_exclude_shared_rim_rows_out"]
    exclude_outer = _flag(gp, *keys)
    exclude_rim = False
    outer_row_energy_weight = None
    if leaflet == "in":
        exclude_rim = _flag(gp, "tilt_in_exclude_shared_rim_rows",
                            "tilt_exclude_shared_rim_rows_in")
        raw = gp.get("tilt_in_shared_rim_outer_row_energy_weight")
        if raw is not None:
            w = float(raw)
            if not np.isfinite(w) or w < 0.0:
                raise ValueError(
                    "tilt_in_shared_rim_outer_row_energy_weight must be a "
                    "finite non-negative number"
                )
            outer_row_energy_weight = w
    if not (exclude_rim or exclude_outer or outer_row_energy_weight is not None):
        return None

    mesh = layout.mesh
    n = len(layout.vertex_ids)
    groups = [str((mesh.vertices[int(vid)].options or {}).get("rim_slope_match_group") or "")
              for vid in layout.vertex_ids]
    outer_mask = np.array([g == "outer" for g in groups], dtype=bool)
    if not outer_mask.any():
        from membrane_solver_tpu_torch.constraints.local_interface_shells import (
            build_shell_rows,
        )

        shells = build_shell_rows(layout, group="disk")
        if shells is not None:
            outer_mask[np.asarray(shells.outer_rows, dtype=int)] = True
    outer_scale = (
        None if outer_row_energy_weight is None else float(np.sqrt(outer_row_energy_weight))
    )
    weights = np.ones(n, dtype=float)
    for row in range(n):
        if exclude_rim and groups[row] == "rim":
            weights[row] = 0.0
        elif outer_mask[row]:
            if exclude_outer:
                weights[row] = 0.0
            elif outer_scale is not None:
                weights[row] = outer_scale
    return weights


def compile_active_row_weights(layout, leaflet: str):
    """The shared-rim times the trace-layer row weights, or None when neither applies."""
    shared = compile_shared_rim_row_weights(layout, leaflet)
    trace = compile_trace_layer_row_weights(layout)
    if shared is None:
        return trace
    if trace is None:
        return shared
    return shared * trace


def row_weights(topo, leaflet: str):
    return topo.extras.get(f"energy:tilt_{leaflet}/row_weights")


def mass_mode(spec, leaflet: str) -> str:
    return spec.option(f"tilt_mass_mode_{leaflet}", spec.option("tilt_mass_mode", "lumped"))


def leaflet_energy(geo, tilts, topo, k_tilt, present_tri=None, mode: str = "lumped",
                   weights=None):
    if weights is not None:
        tilts = tilts * weights[:, None]
    t0 = tilts[topo.tri_rows[:, 0]]
    t1 = tilts[topo.tri_rows[:, 1]]
    t2 = tilts[topo.tri_rows[:, 2]]
    sq = torch.sum(t0 * t0, dim=1) + torch.sum(t1 * t1, dim=1) + torch.sum(t2 * t2, dim=1)
    if mode == "consistent":
        cross = (torch.sum(t0 * t1, dim=1) + torch.sum(t1 * t2, dim=1)
                 + torch.sum(t2 * t0, dim=1))
        coeff = (k_tilt / 12.0) * (sq + cross)
    else:
        coeff = 0.5 * k_tilt * (sq / 3.0)
    area = geo.area
    if present_tri is not None:
        area = torch.where(present_tri, area, 0.0)
    return torch.sum(coeff * area)


def make_leaflet_energy(spec, leaflet: str):
    mode = mass_mode(spec, leaflet)

    def fn(geo, state, topo, params):
        tilts = state.tilts_in if leaflet == "in" else state.tilts_out
        k = param(params, f"tilt_modulus_{leaflet}", like=tilts)
        return leaflet_energy(geo, tilts, topo, k, present_triangles(topo, leaflet), mode,
                              row_weights(topo, leaflet))

    return fn


def make_leaflet_inloop_energy(spec, leaflet: str):
    """Relax-loop energy: lumped, and the present mask for the outer leaflet only."""

    def fn(geo, state, topo, params):
        tilts = state.tilts_in if leaflet == "in" else state.tilts_out
        k = param(params, f"tilt_modulus_{leaflet}", like=tilts)
        present = present_triangles(topo, "out") if leaflet == "out" else None
        return leaflet_energy(geo, tilts, topo, k, present)

    return fn


def make_leaflet_tilt_frozen(spec, leaflet: str):
    """Frozen split for the inner tilt solve (positions constant).

    In-loop semantics as in the JAX package: lumped mass, no row weights,
    inner leaflet over all triangles and outer leaflet over the
    leaflet-present triangles.  precompute() bakes the areas once per relax
    call; the per-iteration energy is corner gathers and a quadratic form.
    """

    def precompute(state, topo, params):
        from membrane_solver_tpu_torch.device import geo as dgeo

        geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
        area = geo.area
        if leaflet == "out":
            present = present_triangles(topo, "out")
            if present is not None:
                area = torch.where(present, area, 0.0)
        return {"area": area}

    def energy(tin, tout, fr, topo, params, ctx=None):
        k_tilt = param(params, f"tilt_modulus_{leaflet}", like=tin)
        if ctx is not None:
            corners = ctx["tin_c"] if leaflet == "in" else ctx["tout_c"]
            t0, t1, t2 = corners[:, 0], corners[:, 1], corners[:, 2]
        else:
            tilts = tin if leaflet == "in" else tout
            t0 = tilts[topo.tri_rows[:, 0]]
            t1 = tilts[topo.tri_rows[:, 1]]
            t2 = tilts[topo.tri_rows[:, 2]]
        sq = torch.sum(t0 * t0, dim=1) + torch.sum(t1 * t1, dim=1) + torch.sum(t2 * t2, dim=1)
        coeff = 0.5 * k_tilt * (sq / 3.0)
        return torch.sum(coeff * fr["area"])

    return precompute, energy
