"""Inner-leaflet bending-tilt coupling (kappa_key=bending_modulus_in, div_sign=-1.0).

Counterpart of ``membrane_solver_tpu/energy/bending_tilt_in.py``.
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import bending_tilt_leaflet as _bt
from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles

USES_TILT_LEAFLETS = True

_KW = dict(kappa_key="bending_modulus_in", div_sign=-1.0, c0_key="spontaneous_curvature_in")


def make_energy(spec):
    def fn(geo, state, topo, params):
        return _bt.leaflet_bending_tilt_energy(
            state, topo, params, tilts=state.tilts_in,
            tri_present=present_triangles(topo, "in"), **_KW,
        )

    return fn


def make_tilt_frozen(spec):
    """Frozen-geometry split for the inner tilt solve (positions constant)."""
    return _bt.make_leaflet_bending_tilt_frozen(spec, leaflet="in", **_KW)


def compile_topology(layout) -> dict:
    _bt.check_default_modes(layout, "in")
    return {}
