"""Legacy mean-curvature + tilt stub (inert; kept for name parity).

Counterpart of ``membrane_solver_tpu/energy/mean_curvature_tilt.py``: the
module registers, contributes zero energy and logs a deprecation warning
once per process.  The coupled formulation lives in ``bending_tilt`` /
``bending_tilt_leaflet``.
"""

from __future__ import annotations

import logging

USES_TILT = True

_warned = False


def energy(geo, state, topo, params):
    global _warned
    if not _warned:
        logging.getLogger("membrane_solver_tpu_torch").warning(
            "mean_curvature_tilt is a legacy stub; use bending_tilt instead"
        )
        _warned = True
    return state.positions.new_zeros(())
