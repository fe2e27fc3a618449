"""Test-fixture constraint module: its enforcement returns the state unchanged.

Counterpart of ``membrane_solver_tpu/constraints/dummy_module.py``.
"""

from __future__ import annotations


def enforce(state, topo, params, context: str = "minimize"):
    return state
