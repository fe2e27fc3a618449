"""Hard global surface-area constraint.

Counterpart of ``membrane_solver_tpu/constraints/global_area.py``: when the
global parameter ``target_surface_area`` is set, the positions are
projected along the total area gradient until |A - A0| < 1e-12 (3
iterations), fixed vertices staying put.  The total area and its vertex
gradient come from one call of the surface whole call
(``kernels/tri_kernels.surface_energy_and_gradient``) with unit tension
on the valid triangles: the CUDA kernel on the card (its vertex sum in
corner-CSR order), its twin on the CPU.  The iterations take no host read.
"""

from __future__ import annotations

import dataclasses

import torch

from membrane_solver_tpu_torch.kernels import tri_kernels

TOL = 1e-12
MAX_ITER = 3


def _total_area_and_gradient(positions, topo):
    return tri_kernels.surface_energy_and_gradient(
        positions, topo.tri_rows, topo.tri_valid, torch.ones_like(topo.tri_surface_tension),
        topo.corner_csr(), tri_kernels.workspace(topo, positions))


def enforce(state, topo, params, context: str = "minimize"):
    target = params.get("target_surface_area")
    if target is None:
        return state
    movable = (~topo.fixed_mask)[:, None].to(state.positions.dtype)
    pos = state.positions
    for _ in range(MAX_ITER):
        area, grad = _total_area_and_gradient(pos, topo)
        delta = area - target
        norm_sq = torch.sum(grad * grad)
        lam = delta / (norm_sq + 1e-18)
        needs = (torch.abs(delta) >= TOL) & (norm_sq >= 1e-18)
        pos = torch.where(needs, pos - lam * grad * movable, pos)
    return dataclasses.replace(state, positions=pos)
