"""Line-tension energy: E = sum over tagged edges of gamma_e * |edge|.

Counterpart of ``membrane_solver_tpu/energy/line_tension.py``: an edge
takes part when its options list the ``line_tension`` energy or carry a
``line_tension`` value; gamma is that value, else the global
``line_tension``; edges shorter than 1e-15 contribute nothing (zero
gradient).
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.energy import param

USES_TILT = False
USES_TILT_LEAFLETS = False


def compile_topology(layout) -> dict:
    """Per-edge activation mask and explicit-gamma table."""
    n = len(layout.edge_ids)
    active = np.zeros(n, dtype=bool)
    explicit = np.zeros(n, dtype=np.float64)
    has_explicit = np.zeros(n, dtype=bool)
    for slot, eid in enumerate(layout.edge_ids):
        opts = layout.mesh.edges[eid].options or {}
        energy = opts.get("energy")
        tagged = (
            energy == "line_tension"
            or (isinstance(energy, (list, tuple)) and "line_tension" in energy)
            or "line_tension" in opts
        )
        if tagged:
            active[slot] = True
            if "line_tension" in opts:
                explicit[slot] = float(opts["line_tension"])
                has_explicit[slot] = True
    return {"active": active, "gamma": explicit, "has_gamma": has_explicit}


def energy(geo, state, topo, params):
    x = lambda key: topo.extras[f"energy:line_tension/{key}"]  # noqa: E731
    positions = state.positions
    active = x("active") & topo.edge_valid
    gamma = torch.where(x("has_gamma"), x("gamma"), param(params, "line_tension", like=positions))
    vecs = positions[topo.edge_rows[:, 1]] - positions[topo.edge_rows[:, 0]]
    lengths = dgeo.safe_norm(vecs, eps=1e-15)
    return torch.sum(torch.where(active, gamma * lengths, 0.0))
