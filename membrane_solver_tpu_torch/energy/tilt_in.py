"""Inner-leaflet tilt magnitude energy.

Counterpart of ``membrane_solver_tpu/energy/tilt_in.py``.
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import tilt_leaflet as _tl

USES_TILT_LEAFLETS = True


def make_energy(spec):
    return _tl.make_leaflet_energy(spec, "in")


def make_inloop_energy(spec):
    """Relax-loop objective (see tilt_leaflet.make_leaflet_inloop_energy)."""
    return _tl.make_leaflet_inloop_energy(spec, "in")


def make_tilt_frozen(spec):
    """Frozen-geometry split for the inner tilt solve (positions constant)."""
    return _tl.make_leaflet_tilt_frozen(spec, "in")


def compile_topology(layout) -> dict:
    _tl.check_row_weights(layout, "in")
    return {}
