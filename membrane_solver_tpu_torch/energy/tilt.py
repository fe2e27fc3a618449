"""Single-field tilt magnitude energy: E = 1/2 k_t sum |t|^2 A_v.

Counterpart of ``membrane_solver_tpu/energy/tilt.py``: the lumped leaflet
core (``tilt_leaflet.leaflet_energy``) on the single ``tilts`` field, with
``tilt_rigidity`` falling back to ``tilt_modulus``.
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import param
from membrane_solver_tpu_torch.energy.tilt_leaflet import leaflet_energy

USES_TILT = True


def energy(geo, state, topo, params):
    k = param(params, "tilt_rigidity", "tilt_modulus", like=state.tilts)
    return leaflet_energy(geo, state.tilts, topo, k)
