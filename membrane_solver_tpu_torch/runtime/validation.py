"""Topology validators run at minimize() start.

Copy of ``membrane_solver_tpu/runtime/validation.py`` (only the import
paths differ), without ``validate_gaussian_curvature_topology``, which
belongs to the ``gaussian_curvature`` module the port does not run.

Parity: reference ``runtime/interface_validation.py`` (disk-boundary rings
must straddle disk<->membrane triangles — opt-in via
``disk_interface_validate``) and ``runtime/leaflet_validation.py`` (strict
leaflet-absence mode rejects triangles that straddle absent/present
vertices).  Both raise ValueError with example entities, before any device
work happens.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from membrane_solver_tpu_torch.energy.leaflet_presence import _normalize_preset_list


@dataclasses.dataclass(frozen=True)
class DiskInterfaceIssue:
    vertex_id: int
    incident_presets: tuple


@dataclasses.dataclass(frozen=True)
class LeafletBoundaryIssue:
    tri_index: int
    rows: tuple
    presets: tuple


def _disk_group_vids(mesh, group: str):
    vids = []
    for vid, v in mesh.vertices.items():
        opts = v.options or {}
        if (
            opts.get("rim_slope_match_group") == group
            or opts.get("tilt_thetaB_group") == group
            or opts.get("tilt_thetaB_group_in") == group
        ):
            vids.append(int(vid))
    return vids


def validate_disk_interface_topology(mesh, global_params) -> None:
    """interface_validation.py:21-172 (tag- or radius-based straddle check)."""
    if not bool(global_params.get("disk_interface_validate", False)):
        return
    group = global_params.get("rim_slope_match_disk_group")
    if group is None or not str(group).strip():
        return
    group = str(group).strip()
    rim_group = str(global_params.get("rim_slope_match_group") or "").strip()
    outer_group = str(global_params.get("rim_slope_match_outer_group") or "").strip()

    if rim_group and rim_group == group:
        raise ValueError(
            "rim_slope_match_group matches rim_slope_match_disk_group; "
            "this self-couples the rim slope constraint on the disk ring. "
            "Use a distinct rim group on the membrane-side ring."
        )

    vids = _disk_group_vids(mesh, group)
    if not vids:
        return
    mesh.build_connectivity_maps()
    center = np.asarray(
        global_params.get("rim_slope_match_center")
        or global_params.get("tilt_thetaB_center")
        or [0.0, 0.0, 0.0],
        dtype=float,
    ).reshape(3)
    ring_r = [
        float(np.linalg.norm((mesh.vertices[v].position - center)[:2])) for v in vids
    ]
    R = float(np.median(ring_r)) if ring_r else 0.0
    tol = max(1e-8, 1e-6 * max(1.0, abs(R)))

    issues = []
    for vid in vids:
        incident = mesh.vertex_to_facets.get(int(vid)) or set()
        presets = set()
        r_vals = []
        for fid in incident:
            for v2 in mesh.facet_vertex_loop(mesh.facets[int(fid)]):
                opts = mesh.vertices[int(v2)].options or {}
                presets.add(str(opts.get("preset") or ""))
                p = mesh.vertices[int(v2)].position
                r_vals.append(float(np.linalg.norm((p - center)[:2])))
        has_disk = any(p.startswith("disk") for p in presets if p)
        has_other = any(p and not p.startswith("disk") for p in presets)
        has_inner = any(r < R - tol for r in r_vals) if R > 0.0 else False
        has_outer = any(r > R + tol for r in r_vals) if R > 0.0 else False
        if not ((has_disk and has_other) or (has_inner and has_outer)):
            issues.append(
                DiskInterfaceIssue(
                    vertex_id=int(vid), incident_presets=tuple(sorted(presets))
                )
            )
    if issues:
        raise ValueError(
            "Disk interface topology invalid: rim_slope_match_disk_group is set, "
            "but the tagged disk boundary vertices do not straddle disk<->membrane "
            "triangles (the ring looks internal to the disk patch). "
            f"bad_vertices={len(issues)} examples={issues[:5]}"
        )


def validate_leaflet_absence_topology(mesh, global_params) -> None:
    """leaflet_validation.py:22-87 (strict mode rejects straddling triangles)."""
    mode = str(global_params.get("leaflet_out_absence_mode", "strict") or "strict")
    if mode.strip().lower() in {"triangles", "facet", "facets", "triangle"}:
        return
    presets = set(
        _normalize_preset_list(global_params.get("leaflet_out_absent_presets"))
    )
    if not presets:
        return
    tri_rows, _ = mesh.triangle_rows()
    tri_rows = np.asarray(tri_rows, dtype=int)
    if tri_rows.size == 0:
        return
    vertex_ids = sorted(mesh.vertices)
    absent = np.zeros(len(vertex_ids), dtype=bool)
    for row, vid in enumerate(vertex_ids):
        opts = mesh.vertices[vid].options or {}
        if opts.get("preset") in presets:
            absent[row] = True
    if not absent.any():
        return
    tri_abs = absent[tri_rows]
    bad = np.any(tri_abs, axis=1) & np.any(~tri_abs, axis=1)
    if not bad.any():
        return
    examples = []
    for idx in np.nonzero(bad)[0][:5]:
        rows = tuple(int(x) for x in tri_rows[idx])
        ex_presets = tuple(
            str((mesh.vertices[vertex_ids[r]].options or {}).get("preset") or "")
            for r in rows
        )
        examples.append(
            LeafletBoundaryIssue(tri_index=int(idx), rows=rows, presets=ex_presets)
        )
    raise ValueError(
        "Leaflet absence topology invalid: outer leaflet marked absent on some "
        "presets but mesh contains triangles that straddle absent/present "
        f"vertices. bad_triangles={int(bad.sum())} examples={examples}"
    )
