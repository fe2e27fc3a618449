"""Energy module registry.

Counterpart of ``membrane_solver_tpu/energy/__init__.py``.  A module
``membrane_solver_tpu_torch.energy.<name>`` provides
``energy(geo, state, topo, params)`` or ``make_energy(spec)`` returning a
function of the same arguments, plus the optional hooks the JAX package
defines (``make_inloop_energy``, ``make_tilt_frozen``, ``compile_topology``).
Only the modules of the kozlov coupled-tilt lane are ported; any other name
raises NotImplementedError.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

PORTED = (
    "surface",
    "tilt_in",
    "tilt_out",
    "bending_tilt_in",
    "bending_tilt_out",
    "tilt_thetaB_contact_in",
)

_CACHE: Dict[str, ModuleType] = {}


def get_module(name: str) -> ModuleType:
    if name not in PORTED:
        raise NotImplementedError(
            f"energy module {name!r} is not ported to membrane_solver_tpu_torch"
        )
    if name not in _CACHE:
        _CACHE[name] = importlib.import_module(f"membrane_solver_tpu_torch.energy.{name}")
    return _CACHE[name]


def param(params, *keys, like):
    """The first of ``keys`` present in ``params``, else a zero like ``like``."""
    for key in keys:
        if key in params:
            return params[key]
    return like.new_zeros(())
