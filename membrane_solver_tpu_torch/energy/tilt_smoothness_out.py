"""Outer-leaflet tilt smoothness (Dirichlet) energy.

Counterpart of ``membrane_solver_tpu/energy/tilt_smoothness_out.py``: the
cotan Dirichlet form of ``tilt_out``'s field over its present triangles,
rigidity ``bending_modulus_out`` (falling back to ``bending_modulus``), no
shape gradient (see ``tilt_smoothness_leaflet``).
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import tilt_smoothness_leaflet as _sl

USES_TILT_LEAFLETS = True


def make_energy(spec):
    return _sl.leaflet_energy(spec, "out")


def make_tilt_frozen(spec):
    """Frozen-geometry split for the inner tilt solve (positions constant)."""
    return _sl.make_leaflet_smoothness_frozen(spec, "out")
