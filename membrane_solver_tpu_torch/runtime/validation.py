"""Topology validators run at minimize() start.

Copy of ``membrane_solver_tpu/runtime/validation.py`` (only the import
paths and the logger's name differ).

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


def validate_gaussian_curvature_topology(mesh, global_params) -> None:
    """Gauss-Bonnet topology validation for the gaussian_curvature module.

    ``gaussian_curvature_check_defects`` warns when the closed-surface
    angle-defect sum drifts from 2*pi*chi beyond 1e-6;
    ``gaussian_curvature_strict_topology`` raises on non-manifold edges,
    boundary vertices of degree != 2, short/missing boundary loops, or
    (closed surfaces) defect mismatch beyond
    ``gaussian_curvature_defect_tol``.
    """
    check = bool(global_params.get("gaussian_curvature_check_defects", False))
    strict = bool(global_params.get("gaussian_curvature_strict_topology", False))
    if not (check or strict):
        return
    import logging
    import math

    from membrane_solver_tpu_torch.runtime.diagnostics.gauss_bonnet import (
        extract_boundary_loops,
        find_boundary_edges,
    )

    mesh.build_connectivity_maps()
    boundary_edges = find_boundary_edges(mesh)
    chi = len(mesh.vertices) - len(mesh.edges) + len(mesh.facets)

    def defect_err() -> tuple:
        positions = mesh.positions_array()
        row_of = {vid: i for i, vid in enumerate(sorted(mesh.vertices))}
        angle_sum = np.zeros(len(row_of))
        for facet in mesh.facets.values():
            loop = mesh.facet_vertex_loop(facet)
            pts = np.array([mesh.vertices[v].position for v in loop])
            for c in range(3):
                a = pts[(c + 1) % 3] - pts[c]
                b = pts[(c + 2) % 3] - pts[c]
                den = max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300)
                cosang = np.clip(np.dot(a, b) / den, -1.0, 1.0)
                angle_sum[row_of[loop[c]]] += math.acos(cosang)
        defect_sum = float(np.sum(2.0 * np.pi - angle_sum))
        target = float(2.0 * np.pi * chi)
        return defect_sum, target, abs(defect_sum - target)

    if check and not boundary_edges:
        defect_sum, target, err = defect_err()
        if err > 1e-6:
            logging.getLogger("membrane_solver_tpu_torch").warning(
                "Gaussian curvature defect sum mismatch: sum(defect)=%.6e, "
                "2pi*chi=%.6e (|delta|=%.3e). Check for non-manifold topology.",
                defect_sum,
                target,
                err,
            )

    if not strict:
        return
    non_manifold = [
        eid for eid, facets in mesh.edge_to_facets.items() if len(facets) > 2
    ]
    if non_manifold:
        raise ValueError(
            "gaussian_curvature strict check: non-manifold edges detected "
            f"(count={len(non_manifold)})."
        )
    if boundary_edges:
        deg: dict = {}
        for eid in boundary_edges:
            e = mesh.edges[eid]
            deg[e.tail_index] = deg.get(e.tail_index, 0) + 1
            deg[e.head_index] = deg.get(e.head_index, 0) + 1
        bad = {vid: cnt for vid, cnt in deg.items() if cnt != 2}
        if bad:
            raise ValueError(
                "gaussian_curvature strict check: boundary vertex degree != 2 "
                f"(count={len(bad)})."
            )
        loops = extract_boundary_loops(mesh, boundary_edges)
        if not loops:
            raise ValueError(
                "gaussian_curvature strict check: boundary edges present "
                "but no loops found."
            )
        short = [loop for loop in loops if len(loop) < 3]
        if short:
            raise ValueError(
                "gaussian_curvature strict check: boundary loop too short "
                f"(count={len(short)})."
            )
        return
    tol = float(global_params.get("gaussian_curvature_defect_tol", 1e-6))
    defect_sum, target, err = defect_err()
    if err > tol:
        raise ValueError(
            "gaussian_curvature strict check: defect sum mismatch "
            f"(sum(defect)={defect_sum:.6e}, 2pi*chi={target:.6e}, |delta|={err:.3e})."
        )
