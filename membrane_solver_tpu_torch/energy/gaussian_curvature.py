"""Gaussian-curvature (Gaussian modulus) energy via Gauss-Bonnet.

Counterpart of ``membrane_solver_tpu/energy/gaussian_curvature.py``: for a
closed surface E = 2 pi kappa_bar chi (a topological constant); with a
boundary E = kappa_bar * G, G = the interior angle defects plus the
boundary turning (pi - angle sum per boundary vertex), which is locally
constant, so no shape gradient flows (the JAX package stops it).
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.energy import param

USES_TILT = False
USES_TILT_LEAFLETS = False


def compile_topology(layout) -> dict:
    mesh = layout.mesh
    mesh.build_connectivity_maps()
    has_boundary = any(len(f) == 1 for f in mesh.edge_to_facets.values())
    chi = len(mesh.vertices) - len(mesh.edges) + len(mesh.facets)
    return {
        "chi": np.asarray(chi, dtype=np.int32),
        "has_boundary": np.asarray(has_boundary),
    }


def gauss_bonnet_total(positions, topo):
    """G = sum interior defects (2pi - theta) + boundary turning (pi - theta)."""
    ang = dgeo.interior_angles(positions, topo.tri_rows, topo.tri_valid)
    angle_sum = dgeo.scatter_add_rows(ang[:, 0], ang[:, 1], ang[:, 2], topo.corner_csr())
    has_angles = angle_sum > 0
    interior = topo.vertex_valid & ~topo.boundary_vertex_mask & has_angles
    boundary = topo.vertex_valid & topo.boundary_vertex_mask & has_angles
    g_int = torch.sum(torch.where(interior, 2.0 * torch.pi - angle_sum, 0.0))
    g_bnd = torch.sum(torch.where(boundary, torch.pi - angle_sum, 0.0))
    return g_int + g_bnd


def energy(geo, state, topo, params):
    positions = state.positions
    kappa_bar = param(params, "gaussian_modulus", like=positions)
    has_boundary = topo.extras["energy:gaussian_curvature/has_boundary"]
    chi = topo.extras["energy:gaussian_curvature/chi"].to(positions.dtype)
    closed = 2.0 * torch.pi * kappa_bar * chi
    g_total = gauss_bonnet_total(positions.detach(), topo)
    return torch.where(has_boundary, kappa_bar * g_total, closed)
