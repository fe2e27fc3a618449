"""Edge-length penalty: E = 0.5 * k * (|edge| - L0)^2 over tagged edges.

Counterpart of ``membrane_solver_tpu/energy/edge_length_penalty.py``: the
edges with a ``target_length`` option; the stiffness is the global
``edge_stiffness`` (default 100).
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo

USES_TILT = False
USES_TILT_LEAFLETS = False


def compile_topology(layout) -> dict:
    n = len(layout.edge_ids)
    active = np.zeros(n, dtype=bool)
    target = np.zeros(n, dtype=np.float64)
    for slot, eid in enumerate(layout.edge_ids):
        opts = layout.mesh.edges[eid].options or {}
        if opts.get("target_length") is not None:
            active[slot] = True
            target[slot] = float(opts["target_length"])
    return {"active": active, "target": target}


def energy(geo, state, topo, params):
    positions = state.positions
    active = topo.extras["energy:edge_length_penalty/active"] & topo.edge_valid
    target = topo.extras["energy:edge_length_penalty/target"]
    k = params.get("edge_stiffness", 100.0)
    vecs = positions[topo.edge_rows[:, 1]] - positions[topo.edge_rows[:, 0]]
    lengths = dgeo.safe_norm(vecs, eps=1e-15)
    contrib = 0.5 * k * (lengths - target) ** 2
    return torch.sum(torch.where(active & (lengths > 0), contrib, 0.0))
