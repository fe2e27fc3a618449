"""Tilt smoothness (Dirichlet) energy on the cotan Laplacian.

Counterpart of ``membrane_solver_tpu/energy/tilt_smoothness.py``:

    E = (k_s / 4) * sum_tri [ c0 |t1 - t2|^2 + c1 |t2 - t0|^2 + c2 |t0 - t1|^2 ]

``ambient_v1`` compares the raw corner vectors; ``connection_v1`` first
transports each corner tilt from its vertex plane into the triangle plane
(minimal rotation).  The energy has a tilt gradient and, by design, no
shape gradient: the cotangents come from ``tri_kernels.curvature_data`` on
detached positions (the JAX package's ``stop_gradient``), so the curvature
kernel's backward never runs for this module.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.reduce import tree_sum
from membrane_solver_tpu_torch.energy import param
from membrane_solver_tpu_torch.kernels import tri_kernels

USES_TILT = True


def minimal_rotation(t, a, b):
    """Minimal rotation taking unit vector a to unit vector b, applied to t."""
    v = torch.linalg.cross(a, b)
    c = torch.sum(a * b, dim=-1, keepdim=True)
    vxt = torch.linalg.cross(v, t)
    vvt = torch.sum(v * t, dim=-1, keepdim=True) * v
    denom = torch.clamp(1.0 + c, min=1e-12)
    return t * c + vxt + vvt / denom


def _transport_to_triangle(positions, tilts, topo):
    """connection_v1: rotate each corner tilt from its vertex plane to the triangle plane."""
    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    vnormals = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())
    return [
        minimal_rotation(tilts[rows], vnormals[rows], geo.unit_normal)
        for rows in topo.tri_rows.unbind(1)
    ]


def smoothness_energy(positions, tilts, topo, k_smooth, transport: str, tri_present=None):
    frozen = positions.detach()  # no shape gradient (see the module docstring)
    curv = tri_kernels.curvature_data(frozen, topo.tri_rows, topo.tri_valid, topo.corner_csr())
    c0, c1, c2 = curv.weights[:, 0], curv.weights[:, 1], curv.weights[:, 2]
    if transport == "connection_v1":
        t0, t1, t2 = _transport_to_triangle(frozen, tilts, topo)
    else:
        t0, t1, t2 = (tilts[rows] for rows in topo.tri_rows.unbind(1))
    d12 = t1 - t2
    d20 = t2 - t0
    d01 = t0 - t1
    per_tri = (
        c0 * torch.sum(d12 * d12, dim=1)
        + c1 * torch.sum(d20 * d20, dim=1)
        + c2 * torch.sum(d01 * d01, dim=1)
    )
    keep = topo.tri_valid if tri_present is None else (topo.tri_valid & tri_present)
    return (k_smooth / 4.0) * tree_sum(torch.where(keep, per_tri, 0.0))


def make_energy(spec):
    transport = spec.option("tilt_transport_model", "ambient_v1")

    def fn(geo, state, topo, params):
        k = param(params, "tilt_smoothness_rigidity", "tilt_smoothness_modulus", like=state.tilts)
        return smoothness_energy(state.positions, state.tilts, topo, k, transport)

    return fn
