"""Constraint module registry.

Counterpart of ``membrane_solver_tpu/constraints/__init__.py``.  Hooks a
module may define (all optional): ``enforce`` / ``make_enforce`` (geometric
projection), ``constraint_gradient_rows``, ``local_constraint_normals``,
``make_compact_constraint_rows`` (shape KKT rows), ``make_enforce_tilts``,
``make_frozen_enforce_tilts``, ``make_tilt_constraint_rows`` and
``make_compact_tilt_rows`` (leaflet-tilt constraints).  Every constraint
module of the JAX package has its counterpart here (``PORTED`` lists them;
``local_interface_shells`` is the shell helper of the curved
local-interface family and has no hooks); a name with no module raises the
JAX package's ``ModuleNotFoundError`` (from ``importlib``).
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

PORTED = (
    "volume",
    "pin_to_plane",
    "pin_to_circle",
    "rim_slope_match_out",
    "tilt_thetaB_boundary_in",
    "global_area",
    "body_area",
    "perimeter",
    "fix_facet_area",
    "fixed_plane",
    "expression",
    "edge",
    "fix_facet_angle",
    "fix_vertex_position",
    "dummy_module",
    "curved_local_interface_hard",
    "curved_local_interface_match",
    "local_interface_shells",
    "rigid_disk",
    "tilt_leaflet_match_rim",
    "tilt_vector_match_rim",
)

_CACHE: Dict[str, ModuleType] = {}


def get_constraint(name: str) -> ModuleType:
    if name not in _CACHE:
        _CACHE[name] = importlib.import_module(f"membrane_solver_tpu_torch.constraints.{name}")
    return _CACHE[name]
