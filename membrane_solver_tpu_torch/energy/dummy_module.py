"""Test-fixture energy module: zero energy, counting its calls.

Counterpart of ``membrane_solver_tpu/energy/dummy_module.py`` (an empty
module of the reference, loaded by name).
"""

from __future__ import annotations

USES_TILT = False
USES_TILT_LEAFLETS = False

CALLS = {"count": 0}


def energy(geo, state, topo, params):
    CALLS["count"] += 1
    return state.positions.new_zeros(())
