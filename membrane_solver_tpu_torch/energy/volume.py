"""Soft volume penalty: E = sum_b 0.5 * k_b * (V_b - V0_b)^2.

Counterpart of ``membrane_solver_tpu/energy/volume.py``: active only in
``volume_constraint_mode == "penalty"`` (``jit_core.active_energy_modules``
drops it otherwise); V0 is 0 for a body without a target; the stiffness is
the body option, else the global ``volume_stiffness``.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.device import geo as dgeo

USES_TILT = False
USES_TILT_LEAFLETS = False


def energy(geo, state, topo, params):
    vols = dgeo.body_volumes(
        state.positions, topo.tri_rows, topo.tri_valid, topo.tri_body, topo.body_valid.shape[0]
    )
    delta = vols - topo.body_target_volume
    contrib = 0.5 * topo.body_volume_stiffness * delta**2
    return torch.sum(torch.where(topo.body_valid, contrib, 0.0))
