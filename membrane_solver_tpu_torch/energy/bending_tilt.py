"""Coupled Helfrich + tilt-splay energy on the single vertex tilt field.

Counterpart of ``membrane_solver_tpu/energy/bending_tilt.py``:

    E = 1/2 integral kappa (2H - c0 + div t)^2 dA

with the mesh's single tilt field ``state.tilts``: the leaflet form
(``bending_tilt_leaflet.leaflet_bending_tilt_energy``) with div_sign +1 and
the plain ``bending_modulus`` / ``spontaneous_curvature``.  On the card it
runs the curvature-data and divergence kernels.
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy.bending_tilt_leaflet import leaflet_bending_tilt_energy

USES_TILT = True


def energy(geo, state, topo, params):
    return leaflet_bending_tilt_energy(
        state,
        topo,
        params,
        tilts=state.tilts,
        kappa_key="bending_modulus",
        div_sign=1.0,
        c0_key="spontaneous_curvature",
    )
