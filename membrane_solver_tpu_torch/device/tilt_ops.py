"""Tilt-field operators: P1 divergence per triangle.

Counterpart of ``membrane_solver_tpu/device/tilt_ops.py``
(``p1_triangle_divergence``): div(t) = sum_i t_i . g_i with
g_i = (n x e_i)/|n|^2.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.device import geo as dgeo


def p1_triangle_divergence(
    positions: torch.Tensor,
    tilts: torch.Tensor,
    tri_rows: torch.Tensor,
    tri_valid: torch.Tensor,
):
    """(div per triangle, triangle areas, shape gradients (F,3,3))."""
    geo = dgeo.triangle_geometry(positions, tri_rows, tri_valid)
    g = dgeo.p1_shape_gradients(geo)
    t0 = tilts[tri_rows[:, 0]]
    t1 = tilts[tri_rows[:, 1]]
    t2 = tilts[tri_rows[:, 2]]
    div = (
        torch.sum(t0 * g[:, 0], dim=1)
        + torch.sum(t1 * g[:, 1], dim=1)
        + torch.sum(t2 * g[:, 2], dim=1)
    )
    div = torch.where(tri_valid, div, 0.0)
    return div, geo.area, g
