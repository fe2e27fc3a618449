"""Evolver-style vertex averaging (smoothing).

Copy of ``membrane_solver_tpu/runtime/vertex_average.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``runtime/vertex_average.py`` (itself modeled on Surface
Evolver ``veravg.c`` soapfilm averaging):

    x_new = x_old + 0.25 * sum(w_e^2 * (x_nbr - x_old)) / sum(w_e^2)

with w_e the summed areas of the facets incident to edge e; skips fixed and
pin_to_circle vertices; requires both endpoints to share the same
pin-to-circle group; vertices with <= 1 usable edge are left alone; optional
per-facet area restoration when explicit target areas exist.

This pass is two segment-sums and runs vectorized in NumPy on the host (it is
called a handful of times per evolution; positions then sync to device).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from membrane_solver_tpu_torch.geometry.mesh import Mesh

logger = logging.getLogger("membrane_solver_tpu_torch")


def _pin_to_circle_group(options) -> Optional[str]:
    if not options:
        return None
    cons = options.get("constraints")
    has = cons == "pin_to_circle" or (isinstance(cons, list) and "pin_to_circle" in cons)
    if not has:
        return None
    group = options.get("pin_to_circle_group")
    return "default" if group is None else str(group)


def vertex_average(mesh: Mesh) -> None:
    mesh.build_connectivity_maps()

    facet_area = mesh.all_facet_areas()
    edge_weight = {
        int(eid): float(sum(facet_area.get(fid, 0.0) for fid in fids))
        for eid, fids in mesh.edge_to_facets.items()
    }

    new_positions = {}
    for vid, vertex in mesh.vertices.items():
        # pin_to_circle vertices stay anchored during smoothing
        if vertex.fixed or _pin_to_circle_group(vertex.options) is not None:
            continue
        edge_ids = mesh.vertex_to_edges.get(vid, set())
        if not edge_ids or len(edge_ids) <= 1:
            continue
        group = _pin_to_circle_group(vertex.options)

        total_w = 0.0
        xsum = np.zeros(3)
        used = 0
        for eid in edge_ids:
            edge = mesh.edges.get(int(eid))
            if edge is None:
                continue
            other = edge.other(vid)
            if group is not None and _pin_to_circle_group(mesh.vertices[other].options) != group:
                continue
            w = edge_weight.get(int(eid), 0.0)
            if w <= 0.0:
                continue
            w2 = w * w
            xsum += w2 * (mesh.vertices[other].position - vertex.position)
            total_w += w2
            used += 1
        if used <= 1 or total_w < 1e-15:
            continue
        new_positions[vid] = vertex.position + 0.25 * (xsum / total_w)

    for vid, pos in new_positions.items():
        mesh.vertices[vid].position = pos

    logger.info("Vertex averaging completed.")

    # area restoration only when explicit targets exist
    any_target = any(
        f.options.get("target_area") is not None for f in mesh.facets.values()
    ) or any(b.options.get("target_area") is not None for b in mesh.bodies.values())
    if not any_target:
        return

    accum: dict = {}
    counts: dict = {}
    for fid, facet in mesh.facets.items():
        # Parity quirk (vertex_average.py:127-133): the reference builds this
        # walk from get_edge(signed) — which already reverses negative edges —
        # and then applies the sign AGAIN, so the picked vertex is always the
        # edge's RAW tail.  Facets whose loops contain negative edges thus
        # produce degenerate walks like [a, b, a] and are silently skipped by
        # the area check below.  Replicate exactly.
        v_ids: list = []
        for signed_ei in facet.edge_indices:
            raw_tail = mesh.get_edge(signed_ei).tail_index
            if not v_ids or v_ids[-1] != raw_tail:
                v_ids.append(raw_tail)
        if len(v_ids) < 3:
            continue
        orig_area = facet_area.get(fid)
        desired = facet.options.get("target_area", orig_area)
        if desired is None:
            continue
        pts = np.array([mesh.vertices[i].position for i in v_ids])
        centroid = pts.mean(axis=0)
        n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
        area_now = 0.5 * np.linalg.norm(n)
        if area_now < 1e-12 or desired < 1e-12:
            continue
        n_hat = n / (np.linalg.norm(n) + 1e-18)
        scale = np.sqrt(desired / area_now)
        for vid, p in zip(v_ids, pts):
            offset = p - centroid
            normal_comp = np.dot(offset, n_hat) * n_hat
            new_p = centroid + scale * (offset - normal_comp) + normal_comp
            accum.setdefault(vid, np.zeros(3))
            counts[vid] = counts.get(vid, 0) + 1
            accum[vid] += new_p

    for vid, total in accum.items():
        mesh.vertices[vid].position = total / counts[vid]
    mesh.increment_version()
