"""Leaflet tilt smoothness (Dirichlet) energy, both leaflets in one module.

Counterpart of ``membrane_solver_tpu/energy/tilt_smoothness_leaflet.py``:
the shared implementation of ``tilt_smoothness_in`` and
``tilt_smoothness_out``, loadable by its own name too.  Each leaflet's
field carries the cotan Dirichlet form of
:func:`~membrane_solver_tpu_torch.energy.tilt_smoothness.smoothness_energy`
over its present triangles, with the rigidity ``bending_modulus_<leaflet>``
(falling back to ``bending_modulus``).  No shape gradient, as in the JAX
package.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.reduce import member_sum
from membrane_solver_tpu_torch.energy import param
from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles
from membrane_solver_tpu_torch.energy.tilt_smoothness import minimal_rotation, smoothness_energy
from membrane_solver_tpu_torch.kernels import tri_kernels

USES_TILT_LEAFLETS = True


def leaflet_rigidity(params, leaflet: str, like):
    return param(params, f"bending_modulus_{leaflet}", "bending_modulus", like=like)


def leaflet_energy(spec, leaflet: str):
    """fn(geo, state, topo, params) of one leaflet's smoothness."""
    transport = spec.option("tilt_transport_model", "ambient_v1")

    def fn(geo, state, topo, params):
        tilts = state.tilts_in if leaflet == "in" else state.tilts_out
        return smoothness_energy(state.positions, tilts, topo,
                                 leaflet_rigidity(params, leaflet, tilts), transport,
                                 present_triangles(topo, leaflet))

    return fn


def make_energy(spec):
    fn_in, fn_out = leaflet_energy(spec, "in"), leaflet_energy(spec, "out")

    def fn(geo, state, topo, params):
        return fn_in(geo, state, topo, params) + fn_out(geo, state, topo, params)

    return fn


def make_leaflet_smoothness_frozen(spec, leaflet: str):
    """Frozen split of one leaflet's smoothness (positions constant).

    precompute() bakes the cotan weights from ``tri_kernels.curvature_data``
    on detached positions and the ``keep`` mask (valid and leaflet-present
    triangles), plus, for connection_v1, the corner vertex normals and the
    triangle unit normals of the transport, once per relax call; the
    per-iteration energy is the Dirichlet form on the (transported) corner
    tilts.  ``runtime/tilt_relax.build_fused_tilt_energy`` folds the ambient
    form into the frozen-tilt kernel's smoothness columns.
    """
    transport = spec.option("tilt_transport_model", "ambient_v1")

    def precompute(state, topo, params):
        positions = state.positions.detach()
        curv = tri_kernels.curvature_data(positions, topo.tri_rows, topo.tri_valid,
                                          topo.corner_csr())
        present = present_triangles(topo, leaflet)
        keep = topo.tri_valid if present is None else (topo.tri_valid & present)
        out = {"weights": curv.weights, "keep": keep}
        if transport == "connection_v1":
            geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
            vn = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())
            out["corner_normals"] = vn[topo.tri_rows]
            out["unit_normal"] = geo.unit_normal
        return out

    def energy(tin, tout, fr, topo, params, ctx=None):
        if ctx is not None:
            corners = ctx["tin_c"] if leaflet == "in" else ctx["tout_c"]
        else:
            corners = (tin if leaflet == "in" else tout)[topo.tri_rows]
        t0, t1, t2 = corners[:, 0], corners[:, 1], corners[:, 2]
        if transport == "connection_v1":
            un, cn = fr["unit_normal"], fr["corner_normals"]
            t0 = minimal_rotation(t0, cn[:, 0], un)
            t1 = minimal_rotation(t1, cn[:, 1], un)
            t2 = minimal_rotation(t2, cn[:, 2], un)
        w = fr["weights"]
        d12 = t1 - t2
        d20 = t2 - t0
        d01 = t0 - t1
        per_tri = (
            w[:, 0] * torch.sum(d12 * d12, dim=1)
            + w[:, 1] * torch.sum(d20 * d20, dim=1)
            + w[:, 2] * torch.sum(d01 * d01, dim=1)
        )
        k = leaflet_rigidity(params, leaflet, tin)
        return (k / 4.0) * member_sum(torch.where(fr["keep"], per_tri, 0.0))

    return precompute, energy


def make_tilt_frozen(spec):
    """Frozen-geometry split of the both-leaflet module."""
    pre_in, fn_in = make_leaflet_smoothness_frozen(spec, "in")
    pre_out, fn_out = make_leaflet_smoothness_frozen(spec, "out")

    def precompute(state, topo, params):
        return {"in": pre_in(state, topo, params), "out": pre_out(state, topo, params)}

    def energy(tin, tout, fr, topo, params, ctx=None):
        return (fn_in(tin, tout, fr["in"], topo, params, ctx)
                + fn_out(tin, tout, fr["out"], topo, params, ctx))

    return precompute, energy
