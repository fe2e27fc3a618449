"""Tilt-field operators: P1 divergence per triangle.

Counterpart of ``membrane_solver_tpu/device/tilt_ops.py``
(``p1_triangle_divergence``): div(t) = sum_i t_i . g_i with
g_i = (n x e_i)/|n|^2.  Plain PyTorch: :func:`p1_triangle_divergence` is the
twin of the ``tri_p1_div`` CUDA kernel (masks included); the energy
modules reach the kernel through ``kernels/tri_kernels``.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.device import geo as dgeo


def p1_divergence_corners(v0, v1, v2, t0, t1, t2):
    """(div (T,), area (T,), g0, g1, g2 (T, 3)) of a tilt field, unmasked.

    The P1 shape gradients ``g_i = (n x e_i) / max(|n|^2, EPS^2)`` with
    ``n = e1 x e2`` and ``e_i`` the edge opposite corner i, the divergence
    ``sum_i t_i . g_i`` and the area ``|n| / 2``: the per-triangle part of
    :func:`p1_triangle_divergence`, whose CUDA kernel (``tri_p1_div``,
    ``kernels/tri_kernels``) replaces the JAX package's ``_p1_div_kernel``.
    """
    e0 = v2 - v1
    e1 = v0 - v2
    e2 = v1 - v0
    n = torch.linalg.cross(e1, e2)
    sq = dgeo._dot(n, n)
    n_sq = torch.clamp(sq, min=dgeo.EPS_AREA * dgeo.EPS_AREA)[:, None]
    g0 = torch.linalg.cross(n, e0) / n_sq
    g1 = torch.linalg.cross(n, e1) / n_sq
    g2 = torch.linalg.cross(n, e2) / n_sq
    div = dgeo._dot(t0, g0) + dgeo._dot(t1, g1) + dgeo._dot(t2, g2)
    area = 0.5 * torch.sqrt(torch.clamp(sq, min=0.0))
    return div, area, g0, g1, g2


def p1_triangle_divergence(
    positions: torch.Tensor,
    tilts: torch.Tensor,
    tri_rows: torch.Tensor,
    tri_valid: torch.Tensor,
):
    """(div per triangle, triangle areas, shape gradients (F,3,3)).

    :func:`p1_divergence_corners` on the gathered corners, with the stock
    function's masks (:func:`mask_divergence`).
    """

    def corners(x):
        return x[tri_rows[:, 0]], x[tri_rows[:, 1]], x[tri_rows[:, 2]]

    return mask_divergence(
        *p1_divergence_corners(*corners(positions), *corners(tilts)), tri_valid
    )


def mask_divergence(div, area, g0, g1, g2, tri_valid: torch.Tensor):
    """``div`` zeroed on invalid triangles, ``area`` masked as ``geo.triangle_geometry``
    masks it, and the shape gradients stacked (F, 3, 3)."""
    div = torch.where(tri_valid, div, 0.0)
    area = torch.where(tri_valid & (2.0 * area >= dgeo.EPS_AREA), area, 0.0)
    return div, area, torch.stack([g0, g1, g2], dim=1)
