"""Leaflet-absence masking helpers.

Counterpart of ``membrane_solver_tpu/energy/leaflet_presence.py``: vertices
whose ``options.preset`` is listed in ``leaflet_{in,out}_absent_presets``
are absent for that leaflet, and triangles touching an absent vertex drop
out of that leaflet's energies.  Under ``rim_slope_match_mode``
``physical_edge_staggered_v1`` with ``leaflet_out_absence_mode`` triangles
(or facets) and the ``disk`` preset absent from the outer leaflet, the
disk-boundary group and the first two free shells stay present for the
outer leaflet, so its continuation across the physical edge carries energy.
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


def _restore_physical_edge_shell_rows(layout, vmask, leaflet: str) -> None:
    """Mark the physical-edge shell rows present for the outer leaflet (in place)."""
    gp = layout.mesh.global_parameters
    if leaflet != "out":
        return
    if "disk" not in set(_normalize_preset_list(gp.get("leaflet_out_absent_presets"))):
        return
    if str(gp.get("rim_slope_match_mode") or "").strip().lower() != "physical_edge_staggered_v1":
        return
    mode = str(gp.get("leaflet_out_absence_mode") or "").strip().lower()
    if mode not in {"triangles", "triangle", "facets", "facet"}:
        return
    from membrane_solver_tpu_torch.constraints.local_interface_shells import build_shell_rows

    shells = build_shell_rows(layout, group="disk")
    if shells is None:
        return
    for rows in (shells.disk_rows, shells.rim_rows, shells.outer_rows):
        vmask[np.asarray(rows, dtype=int)] = False


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
        _restore_physical_edge_shell_rows(layout, vmask, leaflet)
        out[f"absent_{leaflet}"] = vmask
        out[f"tri_present_{leaflet}"] = (
            ~np.any(vmask[tri], axis=1) if len(tri) else np.zeros(0, bool)
        )
    return out


def present_triangles(topo, leaflet: str):
    """(F,) bool present-triangle mask for the leaflet, or None if unmasked."""
    return topo.extras.get(f"energy:leaflet_presence/tri_present_{leaflet}")
