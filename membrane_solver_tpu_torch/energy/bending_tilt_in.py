"""Inner-leaflet bending-tilt coupling (kappa_key=bending_modulus_in, div_sign=-1.0).

Counterpart of ``membrane_solver_tpu/energy/bending_tilt_in.py``: with a
non-empty ``theory_parity_lane`` the divergence is the barycentric recovery,
and under ``bending_tilt_in_scaffold_shape_stencil_mode`` ``trace_boundary_v1``
the trace rows take no z shape gradient from this energy (compiled only
where the mesh has trace rows and scaffold-support or release rows).  The
base-term overrides (flat reference, assume-J0 presets, the
``disk_only_base_term_v1`` region) and ``bending_tilt_in_update_mode`` act
as ``bending_tilt_leaflet`` describes; the compile hook resolves their rows
and the cap's center.
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import bending_tilt_leaflet as _bt
from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles

USES_TILT_LEAFLETS = True

_KW = dict(kappa_key="bending_modulus_in", div_sign=-1.0, c0_key="spontaneous_curvature_in")


def make_energy(spec):
    recovered = _bt.recovered_mode(spec, "in")
    zero_base = _bt.zero_base_mode(spec, "in")
    upd_mode = _bt.update_mode_static(spec, "in")
    stencil_on = _bt.stencil_mode_static(spec) == "trace_boundary_v1"

    def fn(geo, state, topo, params):
        return _bt.leaflet_bending_tilt_energy(
            state, topo, params, tilts=state.tilts_in,
            tri_present=present_triangles(topo, "in"), zero_base=zero_base,
            j0_mask=_bt.combined_zero_mask(topo, "in"), recovered_div=recovered,
            update_mode=upd_mode,
            stencil_trace=(topo.extras.get("energy:bending_tilt_in/stencil_trace")
                           if stencil_on else None),
            **_KW,
        )

    return fn


def make_tilt_frozen(spec):
    """Frozen-geometry split for the inner tilt solve (positions constant)."""
    return _bt.make_leaflet_bending_tilt_frozen(spec, leaflet="in", **_KW)


def compile_topology(layout) -> dict:
    out = _bt.compile_base_masks(layout, "in")
    gp = layout.mesh.global_parameters
    if str(gp.get("bending_tilt_in_update_mode") or "off").strip().lower() == (
            "outer_near_divergence_cap_v1"):
        out["update_center"] = _bt.assume_J0_center_xy(gp)
    mode = str(gp.get("bending_tilt_in_scaffold_shape_stencil_mode") or "off").strip().lower()
    if mode == "trace_boundary_v1":
        tr, su, rl = _bt.compile_scaffold_row_masks(layout)
        if tr.any() and (su.any() or rl.any()):
            out["stencil_trace"] = tr
    return out
