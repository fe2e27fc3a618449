"""Soft body-surface-area penalty: E = 0.5 * k * (A_body - A0)^2.

Counterpart of ``membrane_solver_tpu/energy/body_area_penalty.py``: bodies
with an ``area_target`` option; the stiffness is the body option
``area_stiffness``, else the global value (inert where k == 0).  The
per-body areas are a masked reduction (``geo.body_sums``), which adds in a
fixed order, in place of the JAX package's segment sum.
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.energy import param

USES_TILT = False
USES_TILT_LEAFLETS = False


def compile_topology(layout) -> dict:
    nb = max(len(layout.body_ids), 1)
    target = np.zeros(nb)
    has = np.zeros(nb, dtype=bool)
    k = np.zeros(nb)
    has_k = np.zeros(nb, dtype=bool)
    for slot, bid in enumerate(layout.body_ids):
        opts = layout.mesh.bodies[bid].options
        if opts.get("area_target") is not None:
            target[slot] = float(opts["area_target"])
            has[slot] = True
        if opts.get("area_stiffness") is not None:
            k[slot] = float(opts["area_stiffness"])
            has_k[slot] = True
    return {"target": target, "has": has, "k": k, "has_k": has_k}


def energy(geo, state, topo, params):
    x = lambda key: topo.extras[f"energy:body_area_penalty/{key}"]  # noqa: E731
    areas = dgeo.body_sums(geo.area, topo.tri_body, topo.body_valid.shape[0])
    k = torch.where(x("has_k"), x("k"), param(params, "area_stiffness", like=areas))
    active = topo.body_valid & x("has") & (k != 0.0)
    delta = areas - x("target")
    return torch.sum(torch.where(active, 0.5 * k * delta**2, 0.0))
