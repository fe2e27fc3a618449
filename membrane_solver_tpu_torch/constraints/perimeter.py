"""Hard perimeter (loop length) constraint.

Counterpart of ``membrane_solver_tpu/constraints/perimeter.py``: the global
parameter ``perimeter_constraints`` lists dicts ``{edges: [signed ids],
target_perimeter: float}``; each loop's total length is projected to its
target by Lagrange steps along the length gradient (3 iterations, tol
1e-10), fixed vertices staying put; geometric enforcement only (no KKT
rows).  The length gradient's edge-to-vertex sum (the JAX package's
``.at[].add``) runs over a slot CSR of the edges' endpoint rows in a fixed
order (``kernels/vertex_sum.row_sum``): a vertex ends two edges of a loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.state import kept_slot_csr
from membrane_solver_tpu_torch.kernels import vertex_sum

TOL = 1e-10
MAX_ITER = 3


def _pairs(layout):
    """([(loop_id, tail_row, head_row)], [target per loop])."""
    specs = layout.mesh.global_parameters.get("perimeter_constraints", []) or []
    pairs, targets = [], []
    for loop_id, spec in enumerate(specs):
        edges = spec.get("edges")
        target = spec.get("target_perimeter")
        if not edges or target is None:
            targets.append(0.0)
            continue
        targets.append(float(target))
        for signed in edges:
            edge = layout.mesh.edges[abs(int(signed))]
            pairs.append(
                (loop_id, layout.row_of[edge.tail_index], layout.row_of[edge.head_index])
            )
    return pairs, targets


def compile_static(layout):
    """The number of constrained edges (no enforcement without one)."""
    return len(_pairs(layout)[0])


def compile_topology(layout) -> dict:
    pairs, targets = _pairs(layout)
    m = max(len(pairs), 1)
    loop_of = np.zeros(m, dtype=np.int64)
    rows = np.zeros((m, 2), dtype=np.int64)
    valid = np.zeros(m, dtype=bool)
    for i, (lid, t, h) in enumerate(pairs):
        loop_of[i], rows[i, 0], rows[i, 1], valid[i] = lid, t, h, True
    return {
        "loop": loop_of,
        "rows": rows,
        "valid": valid,
        "target": np.asarray(targets if targets else [0.0]),
    }


def _x(topo, key):
    return topo.extras[f"constraint:perimeter/{key}"]


def make_enforce(spec):
    if not spec.static_of("constraint:perimeter", 0):
        return None

    def enforce(state, topo, params, context: str = "minimize"):
        valid = _x(topo, "valid")
        rows = _x(topo, "rows")
        loop = _x(topo, "loop")
        targets = _x(topo, "target")
        # the edges' tail rows, then their head rows: the JAX package adds
        # every tail term, then every head term, in edge order
        csr = kept_slot_csr(topo, "constraint:perimeter/endpoints", rows.T,
                            state.positions.shape[0])
        movable = (~topo.fixed_mask)[:, None].to(state.positions.dtype)
        positions = state.positions
        for lid in range(targets.shape[0]):
            mine = valid & (loop == lid)
            for _ in range(MAX_ITER):
                vecs = positions[rows[:, 1]] - positions[rows[:, 0]]
                lengths = dgeo.safe_norm(vecs, eps=1e-12)
                perimeter = torch.sum(torch.where(mine, lengths, 0.0))
                dirs = torch.where(
                    (mine & (lengths > 0))[:, None],
                    vecs / torch.clamp(lengths, min=1e-12)[:, None],
                    0.0,
                )
                grad = vertex_sum.row_sum(torch.cat([-dirs, dirs]), csr)
                delta = perimeter - targets[lid]
                norm_sq = torch.sum(grad * grad)
                lam = delta / (norm_sq + 1e-18)
                needs = (torch.abs(delta) >= TOL) & (norm_sq >= 1e-18)
                positions = torch.where(needs, positions - lam * grad * movable, positions)
        return dataclasses.replace(state, positions=positions)

    return enforce
