"""Shared math of the curved local-interface energies.

Counterpart of ``membrane_solver_tpu/energy/_local_interface.py``:

    E = 1/2 s sum_valid ((t_out . r_hat)_rim - phi)^2
    phi = (z_outer - z_rim) / (r_outer - r_rim)      (cylindrical radii)

over the azimuth-matched (``rim_rows_matched[j]``, ``outer_rows[j]``) pairs
of the local shell family (``constraints/local_interface_shells``).  The
radii and r_hat are detached; the "law" keeps the z of phi live (z-only
shape gradients), the "penalty" detaches the positions (tilt gradients
only).
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.constraints.local_interface_shells import (
    build_shell_rows,
    pack_pairs,
)
from membrane_solver_tpu_torch.device.reduce import tree_sum
from membrane_solver_tpu_torch.energy import param


def compile_topology_pairs(layout) -> dict:
    shells = build_shell_rows(layout)
    if shells is None:
        return pack_pairs(layout, np.zeros(0, dtype=int), np.zeros(0, dtype=int))
    return pack_pairs(layout, shells.rim_rows_matched, shells.outer_rows)


def radial_hat(frozen, rows):
    """(r, r_hat): the cylindrical radius and the unit in-plane radial direction at ``rows``."""
    r = torch.linalg.vector_norm(frozen[rows, :2], dim=1)
    good = r > 1e-12
    xy = torch.where(good[:, None], frozen[rows, :2] / torch.clamp(r, min=1e-12)[:, None], 0.0)
    return r, torch.cat([xy, torch.zeros_like(xy[:, :1])], dim=1)


def interface_mismatch(positions, topo, prefix, *, live_z: bool):
    """(rim rows, r_hat, phi, ok): phi's z live or detached as ``live_z`` says."""
    x = lambda k: topo.extras[f"energy:{prefix}/{k}"]  # noqa: E731
    rim_rows = x("rows_a")
    outer_rows = x("rows_b")
    valid = x("valid")
    frozen = positions.detach()
    zpos = positions if live_z else frozen
    r_rim, r_hat = radial_hat(frozen, rim_rows)
    r_out = torch.linalg.vector_norm(frozen[outer_rows, :2], dim=1)
    dr = r_out - r_rim
    ok = valid & (torch.abs(dr) > 1e-12)
    inv_dr = torch.where(ok, 1.0 / torch.where(ok, dr, 1.0), 0.0)
    phi = torch.where(ok, (zpos[outer_rows, 2] - zpos[rim_rows, 2]) * inv_dr, 0.0)
    return rim_rows, r_hat, phi, ok


def interface_energy(state, topo, params, *, prefix: str, strength_key: str, live_z: bool):
    if f"energy:{prefix}/rows_a" not in topo.extras:
        return state.positions.new_zeros(())
    s = param(params, strength_key, like=state.positions)
    rim_rows, r_hat, phi, ok = interface_mismatch(state.positions, topo, prefix, live_z=live_z)
    diff = torch.where(ok, torch.sum(state.tilts_out[rim_rows] * r_hat, dim=1) - phi, 0.0)
    return 0.5 * s * tree_sum(diff * diff)
