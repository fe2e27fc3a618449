"""Facet patch-label boundary edges/lengths (multi-disk overlays).

Counterpart of ``membrane_solver_tpu/runtime/diagnostics/patches.py``: edges separating
facets with different ``facet.options[patch_key]`` labels, grouped per label
(an edge between two labeled patches appears under both), with optional
inclusion of single-facet mesh-boundary edges.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np


def _facet_patch_label(facet, *, patch_key, patch_values):
    label = (facet.options or {}).get(patch_key)
    if not isinstance(label, str):
        return None
    if patch_values is not None and label not in patch_values:
        return None
    return label


def patch_boundary_edges(
    mesh,
    *,
    patch_key: str = "disk_patch",
    patch_values: Iterable[str] | None = None,
    include_mesh_boundary: bool = False,
) -> Dict[str, List]:
    if not mesh.facets or not mesh.edges:
        return {}
    mesh.build_connectivity_maps()
    allowed = set(patch_values) if patch_values is not None else None
    facet_labels = {
        fid: _facet_patch_label(f, patch_key=patch_key, patch_values=allowed)
        for fid, f in mesh.facets.items()
    }
    grouped: Dict[str, List] = {}
    for eid, incident in mesh.edge_to_facets.items():
        if not include_mesh_boundary and len(incident) < 2:
            continue
        labels = [facet_labels.get(fid) for fid in incident]
        non_null = {lab for lab in set(labels) if lab is not None}
        if not non_null:
            continue
        if len(incident) >= 2 and len(set(labels)) <= 1:
            continue
        for lab in non_null:
            grouped.setdefault(lab, []).append(mesh.edges[eid])
    return grouped


def patch_boundary_lengths(mesh, **kwargs) -> Dict[str, float]:
    """Total boundary length per patch label."""
    out = {}
    for lab, edges in patch_boundary_edges(mesh, **kwargs).items():
        total = 0.0
        for e in edges:
            p0 = np.asarray(mesh.vertices[e.tail_index].position, dtype=float)
            p1 = np.asarray(mesh.vertices[e.head_index].position, dtype=float)
            total += float(np.linalg.norm(p1 - p0))
        out[lab] = total
    return out
