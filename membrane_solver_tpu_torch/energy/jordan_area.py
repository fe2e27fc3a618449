"""Jordan (projected boundary-loop) area penalty.

Counterpart of ``membrane_solver_tpu/energy/jordan_area.py``: the mesh's
boundary loop, projected to the xy-plane, has the shoelace area

    A_J = 0.5 * sum_i (x_i y_{i+1} - x_{i+1} y_i)

and the energy is E = 0.5 * k * (|A_J| - A0)^2 with k = ``jordan_stiffness``
and A0 = ``jordan_target_area`` (inert without a target or with k == 0).
The loop is compiled from the edges with a single adjacent facet, at its
exact length.
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.energy import param

USES_TILT = False
USES_TILT_LEAFLETS = False


def compile_topology(layout) -> dict:
    mesh = layout.mesh
    mesh.build_connectivity_maps()
    boundary_edges = [eid for eid, f in mesh.edge_to_facets.items() if len(f) == 1]
    # order into one loop by walking adjacency
    loop: list = []
    if boundary_edges:
        nxt: dict = {}
        for eid in boundary_edges:
            e = mesh.edges[eid]
            nxt.setdefault(e.tail_index, []).append(e.head_index)
            nxt.setdefault(e.head_index, []).append(e.tail_index)
        start = mesh.edges[boundary_edges[0]].tail_index
        loop = [start]
        prev = None
        current = start
        for _ in range(len(boundary_edges)):
            candidates = [v for v in nxt.get(current, []) if v != prev]
            if not candidates:
                break
            prev, current = current, candidates[0]
            if current == start:
                break
            loop.append(current)
    n = max(len(loop), 1)
    rows = np.zeros(n, dtype=np.int64)
    valid = np.zeros(n, dtype=bool)
    for i, vid in enumerate(loop):
        rows[i] = layout.row_of[vid]
        valid[i] = True
    return {"rows": rows, "valid": valid, "n": np.asarray(len(loop), np.int64)}


def energy(geo, state, topo, params):
    target = params.get("jordan_target_area")
    positions = state.positions
    if target is None:
        return positions.new_zeros(())
    k = param(params, "jordan_stiffness", like=positions)
    rows = topo.extras["energy:jordan_area/rows"]
    valid = topo.extras["energy:jordan_area/valid"]
    n = topo.extras["energy:jordan_area/n"]
    pts = positions[rows]
    x = torch.where(valid, pts[:, 0], 0.0)
    y = torch.where(valid, pts[:, 1], 0.0)
    idx = torch.arange(rows.shape[0], device=rows.device)
    nxt = torch.where(idx + 1 >= n, 0, idx + 1)
    x_next = torch.where(valid, x[nxt], 0.0)
    y_next = torch.where(valid, y[nxt], 0.0)
    area = 0.5 * torch.sum(x * y_next - x_next * y)
    delta = torch.abs(area) - target
    return 0.5 * k * delta**2
