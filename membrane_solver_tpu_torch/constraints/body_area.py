"""Hard body surface-area constraint.

Counterpart of ``membrane_solver_tpu/constraints/body_area.py``: bodies with
a ``target_area`` option contribute one KKT gradient row (the area gradient
over the body's triangles) and are projected by Lagrange steps
``x -= lam * grad(A)`` until |A - A0| < 1e-12 (at most 20 iterations),
fixed vertices staying put.  Each body's area and gradient come from one
call of the surface whole call (``kernels/tri_kernels.
surface_energy_and_gradient``) with tension ``[tri_body == b]`` on the
valid triangles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.kernels import tri_kernels

TOL = 1e-12
MAX_ITER = 20


def compile_topology(layout) -> dict:
    nb = max(len(layout.body_ids), 1)
    target = np.zeros(nb)
    has = np.zeros(nb, dtype=bool)
    for slot, bid in enumerate(layout.body_ids):
        t = layout.mesh.bodies[bid].options.get("target_area")
        if t is not None:
            target[slot] = float(t)
            has[slot] = True
    return {"target": target, "has": has}


def _area_and_gradient(positions, topo, body_slot: int):
    tension = (topo.tri_body == body_slot).to(positions.dtype)
    return tri_kernels.surface_energy_and_gradient(
        positions, topo.tri_rows, topo.tri_valid, tension, topo.corner_csr(),
        tri_kernels.workspace(topo, positions))


def _active(topo):
    return topo.body_valid & topo.extras["constraint:body_area/has"]


def constraint_gradient_rows(state, topo, params):
    active = _active(topo)
    rows = []
    for slot in range(topo.body_valid.shape[0]):
        _area, grad = _area_and_gradient(state.positions, topo, slot)
        rows.append(grad * active[slot].to(grad.dtype))
    return torch.stack(rows, dim=0)


def enforce(state, topo, params, context: str = "minimize"):
    active = _active(topo)
    targets = topo.extras["constraint:body_area/target"]
    movable = (~topo.fixed_mask)[:, None].to(state.positions.dtype)
    positions = state.positions
    for slot in range(topo.body_valid.shape[0]):
        for _ in range(MAX_ITER):
            area, grad = _area_and_gradient(positions, topo, slot)
            delta = area - targets[slot]
            norm_sq = torch.sum(grad * grad)
            lam = delta / (norm_sq + 1e-18)
            needs = active[slot] & (torch.abs(delta) >= TOL) & (norm_sq >= 1e-18)
            positions = torch.where(needs, positions - lam * grad * movable, positions)
    return dataclasses.replace(state, positions=positions)
