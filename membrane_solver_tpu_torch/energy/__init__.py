"""Energy module registry.

Counterpart of ``membrane_solver_tpu/energy/__init__.py``.  A module
``membrane_solver_tpu_torch.energy.<name>`` provides
``energy(geo, state, topo, params)`` or ``make_energy(spec)`` returning a
function of the same arguments, plus the optional hooks the JAX package
defines (``make_inloop_energy``, ``make_tilt_frozen``, ``compile_topology``).
Every energy module of the JAX package has its counterpart here
(``PORTED`` lists them); a name with no module raises the JAX package's
``ModuleNotFoundError`` (from ``importlib``).
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

PORTED = (
    "surface",
    "volume",
    "bending",
    "gaussian_curvature",
    "tilt_in",
    "tilt_out",
    "bending_tilt_in",
    "bending_tilt_out",
    "tilt_thetaB_contact_in",
    "line_tension",
    "jordan_area",
    "edge_length_penalty",
    "body_area_penalty",
    "expression",
    "dummy_module",
    "tilt",
    "tilt_smoothness",
    "tilt_coupling",
    "tilt_smoothness_leaflet",
    "tilt_smoothness_in",
    "tilt_smoothness_out",
    "tilt_splay_twist_in",
    "tilt_disk_target_in",
    "tilt_disk_target_out",
    "tilt_rim_source_in",
    "tilt_rim_source_out",
    "tilt_rim_source_bilayer",
    "tilt_disk_contact_in",
    "bending_tilt",
    "curved_local_interface_law",
    "curved_local_interface_penalty",
    "mean_curvature_tilt",
    "rim_slope_match_out",
)

_CACHE: Dict[str, ModuleType] = {}


def get_module(name: str) -> ModuleType:
    if name not in _CACHE:
        _CACHE[name] = importlib.import_module(f"membrane_solver_tpu_torch.energy.{name}")
    return _CACHE[name]


def param(params, *keys, like):
    """The first of ``keys`` present in ``params``, else a zero like ``like``."""
    for key in keys:
        if key in params:
            return params[key]
    return like.new_zeros(())
