"""Leaflet-absence masking helpers.

Counterpart of ``membrane_solver_tpu/energy/leaflet_presence.py``: vertices
whose ``options.preset`` is listed in ``leaflet_{in,out}_absent_presets``
are absent for that leaflet, and triangles touching an absent vertex drop
out of that leaflet's energies.  The physical-edge shell restoration of the
JAX package belongs to ``rim_slope_match_mode=physical_edge_staggered_v1``,
which the port does not run.
"""

from __future__ import annotations

import numpy as np


def _normalize_preset_list(raw):
    if raw is None:
        return []
    if isinstance(raw, str):
        val = raw.strip()
        return [val] if val else []
    if isinstance(raw, (list, tuple, set)):
        return [str(x).strip() for x in raw if x is not None and str(x).strip()]
    return []


def absent_vertex_rows(layout, leaflet: str) -> np.ndarray:
    """Boolean absent mask over layout vertex rows for one leaflet."""
    mesh = layout.mesh
    gp = mesh.global_parameters
    mask = np.zeros(len(layout.vertex_ids), dtype=bool)
    presets = set(_normalize_preset_list(gp.get(f"leaflet_{leaflet}_absent_presets")))
    if not presets:
        return mask
    for vid, vertex in mesh.vertices.items():
        opts = vertex.options or {}
        if opts.get("preset") in presets:
            mask[layout.row_of[int(vid)]] = True
    return mask


def compile_topology(layout) -> dict:
    """Per-leaflet absent vertex and present triangle masks."""
    gp = layout.mesh.global_parameters
    out = {}
    tri, _fids = layout.mesh.triangle_rows()
    tri = np.asarray(tri, dtype=int)
    for leaflet in ("in", "out"):
        if gp.get(f"leaflet_{leaflet}_absent_presets") is None:
            continue
        vmask = absent_vertex_rows(layout, leaflet)
        out[f"absent_{leaflet}"] = vmask
        out[f"tri_present_{leaflet}"] = (
            ~np.any(vmask[tri], axis=1) if len(tri) else np.zeros(0, bool)
        )
    return out


def present_triangles(topo, leaflet: str):
    """(F,) bool present-triangle mask for the leaflet, or None if unmasked."""
    return topo.extras.get(f"energy:leaflet_presence/tri_present_{leaflet}")
