"""Inner-leaflet bending-tilt coupling (kappa_key=bending_modulus_in, div_sign=-1.0).

Counterpart of ``membrane_solver_tpu/energy/bending_tilt_in.py``: with a
non-empty ``theory_parity_lane`` the divergence is the barycentric recovery,
and under ``bending_tilt_in_scaffold_shape_stencil_mode`` ``trace_boundary_v1``
the trace rows take no z shape gradient from this energy (compiled only
where the mesh has trace rows and scaffold-support or release rows).
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import bending_tilt_leaflet as _bt
from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles

USES_TILT_LEAFLETS = True

_KW = dict(kappa_key="bending_modulus_in", div_sign=-1.0, c0_key="spontaneous_curvature_in")


def make_energy(spec):
    recovered = _bt.recovered_mode(spec, "in")
    stencil_on = _bt.stencil_mode_static(spec) == "trace_boundary_v1"

    def fn(geo, state, topo, params):
        return _bt.leaflet_bending_tilt_energy(
            state, topo, params, tilts=state.tilts_in,
            tri_present=present_triangles(topo, "in"), recovered_div=recovered,
            stencil_trace=(topo.extras.get("energy:bending_tilt_in/stencil_trace")
                           if stencil_on else None),
            **_KW,
        )

    return fn


def make_tilt_frozen(spec):
    """Frozen-geometry split for the inner tilt solve (positions constant)."""
    return _bt.make_leaflet_bending_tilt_frozen(spec, leaflet="in", **_KW)


def compile_topology(layout) -> dict:
    _bt.check_default_modes(layout, "in")
    gp = layout.mesh.global_parameters
    mode = str(gp.get("bending_tilt_in_scaffold_shape_stencil_mode") or "off").strip().lower()
    if mode == "trace_boundary_v1":
        tr, su, rl = _bt.compile_scaffold_row_masks(layout)
        if tr.any() and (su.any() or rl.any()):
            return {"stencil_trace": tr}
    return {}
