"""Leaflet tilt magnitude energy core: E = 1/2 k_t sum_v |t_v|^2 A_v.

Counterpart of ``membrane_solver_tpu/energy/tilt_leaflet.py``: per-triangle
assembly E = sum coeff * A_tri with

    lumped (default):  coeff = 1/2 k (|t0|^2+|t1|^2+|t2|^2)/3
    consistent:        coeff = k/12 (|t0|^2+|t1|^2+|t2|^2 + t0.t1 + t1.t2 + t2.t0)

by ``tilt_mass_mode_<leaflet>`` (falling back to ``tilt_mass_mode``).  The
relax loop scores the lumped form whatever the mode, as in the JAX package.
The shared-rim and trace-layer row weights are not ported: a mesh that asks
for them raises NotImplementedError.
"""

from __future__ import annotations

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


def check_row_weights(layout, leaflet: str) -> None:
    """Raise when the mesh asks for shared-rim active-row weights."""
    gp = layout.mesh.global_parameters
    keys = [
        f"tilt_{leaflet}_exclude_shared_rim_outer_rows",
        f"tilt_exclude_shared_rim_outer_rows_{leaflet}",
    ]
    if leaflet == "out":
        keys += ["tilt_out_exclude_shared_rim_rows", "tilt_exclude_shared_rim_rows_out"]
    wanted = _flag(gp, *keys)
    if leaflet == "in":
        wanted = wanted or _flag(
            gp, "tilt_in_exclude_shared_rim_rows", "tilt_exclude_shared_rim_rows_in"
        )
        wanted = wanted or gp.get("tilt_in_shared_rim_outer_row_energy_weight") is not None
    if wanted:
        raise NotImplementedError(
            f"shared-rim row weights of tilt_{leaflet} are not ported to membrane_solver_tpu_torch"
        )


def mass_mode(spec, leaflet: str) -> str:
    return spec.option(f"tilt_mass_mode_{leaflet}", spec.option("tilt_mass_mode", "lumped"))


def leaflet_energy(geo, tilts, topo, k_tilt, present_tri=None, mode: str = "lumped"):
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
        return leaflet_energy(geo, tilts, topo, k, present_triangles(topo, leaflet), mode)

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
