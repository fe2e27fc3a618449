"""Hard volume constraint (Lagrange KKT rows + geometric projection).

Counterpart of ``membrane_solver_tpu/constraints/volume.py``:

- ``constraint_gradient_rows``: one dense volume gradient per body slot
  (zero for a slot without a target), fed to the KKT projector's dense
  channel;
- ``enforce``: iterative Lagrange projection ``x -= lam * grad(V)`` until
  ``|V - V0| < 1e-12``, 3 iterations in the "minimize" context and 12
  otherwise; fixed vertices do not move but their gradient rows count in
  the normalization.

The JAX package runs a fixed-trip ``fori_loop`` whose iterations leave the
positions unchanged once the body is within tolerance; here the loop is a
Python loop over the same trip count with the same masked update, so no
iteration reads a device value.
"""

from __future__ import annotations

import dataclasses

import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.reduce import member_sum

TOL = 1e-12
MAX_ITER_MINIMIZE = 3
MAX_ITER_STRONG = 12


def _body_active(topo):
    return topo.body_valid & topo.body_has_target


def _volume_and_gradient(positions, topo, body_slot: int):
    """Volume of one body slot and its dense gradient over all vertex rows."""
    in_body = (topo.tri_body == body_slot) & topo.tri_valid
    v0 = positions[topo.tri_rows[:, 0]]
    v1 = positions[topo.tri_rows[:, 1]]
    v2 = positions[topo.tri_rows[:, 2]]
    m = in_body.to(positions.dtype)[:, None]
    c12 = torch.linalg.cross(v1, v2)
    vol = member_sum(torch.where(in_body, torch.sum(c12 * v0, dim=1), 0.0)) / 6.0
    g0 = c12 * (m / 6.0)
    g1 = torch.linalg.cross(v2, v0) * (m / 6.0)
    g2 = torch.linalg.cross(v0, v1) * (m / 6.0)
    grad = dgeo.scatter_add_rows(g0, g1, g2, topo.corner_csr())
    return vol, grad


def constraint_gradient_rows(state, topo, params):
    """(n_body_slots, Nv, 3) volume gradients; zero rows for inactive slots."""
    active = _body_active(topo)
    rows = []
    for slot in range(topo.body_valid.shape[0]):
        _vol, grad = _volume_and_gradient(state.positions, topo, slot)
        rows.append(grad * active[slot].to(grad.dtype))
    return torch.stack(rows, dim=0)


def enforce(state, topo, params, context: str = "minimize"):
    """Geometric volume projection for every constrained body."""
    max_iter = MAX_ITER_MINIMIZE if context == "minimize" else MAX_ITER_STRONG
    active = _body_active(topo)
    movable = (~topo.fixed_mask)[:, None].to(state.positions.dtype)
    positions = state.positions
    for slot in range(topo.body_valid.shape[0]):
        target = topo.body_target_volume[slot]
        for _ in range(max_iter):
            vol, grad = _volume_and_gradient(positions, topo, slot)
            delta = vol - target
            lam = delta / (member_sum(grad * grad) + 1e-12)
            needs = active[slot] & (torch.abs(delta) >= TOL)
            positions = torch.where(needs, positions - lam * grad * movable, positions)
    return dataclasses.replace(state, positions=positions)
