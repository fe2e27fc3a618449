"""Constraint module registry.

Counterpart of ``membrane_solver_tpu/constraints/__init__.py``.  Hooks a
module may define (all optional): ``enforce`` / ``make_enforce`` (geometric
projection), ``constraint_gradient_rows``, ``local_constraint_normals``,
``make_compact_constraint_rows`` (shape KKT rows), ``make_enforce_tilts``,
``make_frozen_enforce_tilts``, ``make_tilt_constraint_rows`` and
``make_compact_tilt_rows`` (leaflet-tilt constraints).  Only the modules of
the kozlov coupled-tilt lane are ported; any other name raises
NotImplementedError.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

PORTED = (
    "pin_to_plane",
    "pin_to_circle",
    "rim_slope_match_out",
    "tilt_thetaB_boundary_in",
)

_CACHE: Dict[str, ModuleType] = {}


def get_constraint(name: str) -> ModuleType:
    if name not in PORTED:
        raise NotImplementedError(
            f"constraint module {name!r} is not ported to membrane_solver_tpu_torch"
        )
    if name not in _CACHE:
        _CACHE[name] = importlib.import_module(f"membrane_solver_tpu_torch.constraints.{name}")
    return _CACHE[name]
