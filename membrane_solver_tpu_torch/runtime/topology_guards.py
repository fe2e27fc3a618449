"""Host-side topology hazard checks.

Copy of ``membrane_solver_tpu/runtime/topology_guards.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``runtime/topology.py`` — ``detect_vertex_edge_collisions``
(topology.py:84-199) finds vertices dangerously close to non-incident edges
(candidates for refine/pop handling); the in-jit normal-flip and min-edge
guards live in device/geo (check_normal_rotation, min_edge_length).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def detect_vertex_edge_collisions(mesh, threshold: float = 1e-3) -> List[Tuple[int, int]]:
    """(vertex_id, edge_id) pairs with point-to-segment distance < threshold.

    Exact reference candidate rule (topology.py:128-169): degenerate edges
    (len^2 <= 1e-12) are skipped, and only projections falling STRICTLY
    inside the parameter band 0.05 < t < 0.95 count — a vertex whose foot
    lands near an endpoint (e.g. a rim vertex beside a fan of edges that
    share its neighbor) is never a collision.  An earlier version clamped
    t to [0, 1], which flagged every endpoint-adjacent vertex within
    `threshold` of a neighboring vertex position (120 spurious warnings on
    the converged catenoid lane where the reference's own run emits none).

    Vectorized O(V*E) numpy (the reference's loop is the same complexity).
    """
    ids = mesh.vertex_ids
    pos = mesh.positions_array()
    row_of = mesh.vertex_index_to_row
    edge_ids, tails, heads = [], [], []
    for eid, edge in mesh.edges.items():
        if edge.tail_index in row_of and edge.head_index in row_of:
            edge_ids.append(int(eid))
            tails.append(row_of[edge.tail_index])
            heads.append(row_of[edge.head_index])
    if not edge_ids:
        return []
    t = np.asarray(tails)
    h = np.asarray(heads)
    a = pos[t]  # (E, 3)
    b = pos[h]
    # reference topology.py:128-134: drop degenerate edges up front
    lens_sq = np.einsum("ij,ij->i", b - a, b - a)
    good = lens_sq > 1e-12
    if not np.any(good):
        return []
    t, h, a, b = t[good], h[good], a[good], b[good]
    edge_ids = [eid for eid, g in zip(edge_ids, good) if g]

    # x-interval prefilter: a vertex within `threshold` of a segment lies
    # inside the segment's x-range grown by threshold.  Sorting vertices by
    # x turns the candidate set per edge into a contiguous slice, shrinking
    # the exact O(V*E) distance test to the few real candidates.
    order = np.argsort(pos[:, 0], kind="stable")
    xs = pos[order, 0]
    lo = np.searchsorted(xs, np.minimum(a[:, 0], b[:, 0]) - threshold, side="left")
    hi = np.searchsorted(xs, np.maximum(a[:, 0], b[:, 0]) + threshold, side="right")
    counts = hi - lo
    if int(counts.sum()) == 0:
        return []
    e_idx = np.repeat(np.arange(len(edge_ids)), counts)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    v_sorted_idx = np.arange(int(counts.sum())) - np.repeat(starts, counts) + np.repeat(lo, counts)
    v_idx = order[v_sorted_idx]

    pa = pos[v_idx] - a[e_idx]
    d = b[e_idx] - a[e_idx]
    dd = np.einsum("ij,ij->i", d, d)
    s = np.einsum("ij,ij->i", pa, d) / dd
    # strict interior band (reference topology.py:151): projections near an
    # endpoint are not collisions, which also excludes the edge's own
    # endpoints and their coincident pinned twins
    band = (s > 0.05) & (s < 0.95)
    closest = a[e_idx] + s[:, None] * d
    dist = np.linalg.norm(pos[v_idx] - closest, axis=1)
    keep = band & (dist < threshold)
    return [
        (int(ids[v]), int(edge_ids[e]))
        for v, e in zip(v_idx[keep], e_idx[keep])
    ]
