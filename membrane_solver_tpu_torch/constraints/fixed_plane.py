"""Project all movable vertices onto a fixed plane.

Counterpart of ``membrane_solver_tpu/constraints/fixed_plane.py``: the
plane comes from the global parameters ``fixed_plane_normal`` /
``fixed_plane_point`` (default z = 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def compile_topology(layout) -> dict:
    gp = layout.mesh.global_parameters
    normal = np.asarray(gp.get("fixed_plane_normal") or [0.0, 0.0, 1.0], dtype=float)
    nn = np.linalg.norm(normal)
    normal = normal / nn if nn > 1e-15 else np.array([0.0, 0.0, 1.0])
    point = np.asarray(gp.get("fixed_plane_point") or [0.0, 0.0, 0.0], dtype=float)
    return {"normal": normal, "point": point}


def enforce(state, topo, params, context: str = "minimize"):
    pos = state.positions
    normal = topo.extras["constraint:fixed_plane/normal"].to(pos.dtype)
    point = topo.extras["constraint:fixed_plane/point"].to(pos.dtype)
    dist = torch.sum((pos - point) * normal, dim=1)
    proj = pos - dist[:, None] * normal
    movable = (~topo.fixed_mask) & topo.vertex_valid
    return dataclasses.replace(state, positions=torch.where(movable[:, None], proj, pos))
