"""Energy module registry.

Counterpart of ``membrane_solver_tpu/energy/__init__.py``.  A module
``membrane_solver_tpu_torch.energy.<name>`` provides
``energy(geo, state, topo, params)`` or ``make_energy(spec)`` returning a
function of the same arguments, plus the optional hooks the JAX package
defines (``make_inloop_energy``, ``make_tilt_frozen``, ``compile_topology``).
Ported: the modules of the kozlov coupled-tilt lane, of the Helfrich
vesicle lane (volume, bending, gaussian_curvature), of the shape family
(line_tension, jordan_area, edge_length_penalty, body_area_penalty,
expression, and the reference's empty ``dummy_module``) and the
single-field tilt modules (tilt, tilt_smoothness) with the inter-leaflet
tilt_coupling, and the leaflet tilt-field energies (the smoothness of each
leaflet and of both, splay-twist, the disk targets, the rim sources and the
disk contact); any other name raises NotImplementedError.
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
