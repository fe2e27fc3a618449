"""Discrete Gauss-Bonnet invariants and drift monitoring.

Counterpart of ``membrane_solver_tpu/runtime/diagnostics/gauss_bonnet.py``:

    G = K_int + B,
    K_int = sum over interior vertices of (2 pi - angle sum),
    B     = sum over boundary loops of sum_v (pi - angle sum_v),

with per-loop drift tolerances c * sqrt(N) * eps_angle tracked by
:class:`GaussBonnetMonitor` against the baseline mesh.  Host-side (numpy):
these are report-only quantities outside the solver's device path.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger("membrane_solver_tpu_torch")


def _included_facets(mesh, facet_filter):
    if facet_filter is None:
        return list(mesh.facets.keys())
    return [fid for fid, f in mesh.facets.items() if facet_filter(f)]


def find_boundary_edges(mesh, *, facet_filter=None) -> List[int]:
    """Edges with fewer than two included incident facets."""
    counts: Dict[int, int] = {}
    for fid in _included_facets(mesh, facet_filter):
        for signed_ei in mesh.facets[fid].edge_indices:
            counts[abs(signed_ei)] = counts.get(abs(signed_ei), 0) + 1
    return [eid for eid, c in counts.items() if c < 2]


def extract_boundary_loops(mesh, boundary_edges: List[int]) -> List[List[int]]:
    """Chain boundary edges into closed/open vertex loops (vertex ids)."""
    adj: Dict[int, list] = {}
    for eid in boundary_edges:
        e = mesh.edges[eid]
        adj.setdefault(e.tail_index, []).append((eid, e.head_index))
        adj.setdefault(e.head_index, []).append((eid, e.tail_index))
    unused = set(boundary_edges)
    loops: List[List[int]] = []
    while unused:
        eid = min(unused)
        unused.discard(eid)
        e = mesh.edges[eid]
        loop = [e.tail_index, e.head_index]
        while True:
            cur = loop[-1]
            nxt = None
            for eid2, other in adj.get(cur, []):
                if eid2 in unused:
                    nxt = (eid2, other)
                    break
            if nxt is None:
                break
            unused.discard(nxt[0])
            if nxt[1] == loop[0]:
                break
            loop.append(nxt[1])
        loops.append(loop)
    # canonical rotation: start at the smallest vertex id
    out = []
    for loop in loops:
        i = loop.index(min(loop))
        out.append(loop[i:] + loop[:i])
    return out


def _vertex_angle_sums(mesh, *, facet_filter=None) -> Dict[int, float]:
    sums: Dict[int, float] = {}
    for fid in _included_facets(mesh, facet_filter):
        loop = mesh.facet_vertex_loop(mesh.facets[fid])
        if len(loop) != 3:
            continue
        p = [np.asarray(mesh.vertices[v].position, dtype=float) for v in loop]
        for i in range(3):
            a = p[(i + 1) % 3] - p[i]
            b = p[(i + 2) % 3] - p[i]
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            if na < 1e-15 or nb < 1e-15:
                continue
            cosang = np.clip(np.dot(a, b) / (na * nb), -1.0, 1.0)
            sums[loop[i]] = sums.get(loop[i], 0.0) + float(np.arccos(cosang))
    return sums


def corner_angle(mesh, facet, vertex_id: int) -> float:
    loop = mesh.facet_vertex_loop(facet)
    i = loop.index(int(vertex_id))
    p = [np.asarray(mesh.vertices[v].position, dtype=float) for v in loop]
    a = p[(i + 1) % 3] - p[i]
    b = p[(i + 2) % 3] - p[i]
    cosang = np.clip(
        np.dot(a, b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30), -1.0, 1.0
    )
    return float(np.arccos(cosang))


def interior_angle_deficit(mesh, interior_vids, *, facet_filter=None) -> Dict[int, float]:
    sums = _vertex_angle_sums(mesh, facet_filter=facet_filter)
    return {int(v): float(2.0 * np.pi - sums.get(int(v), 0.0)) for v in interior_vids}


def boundary_geodesic_sum(mesh, boundary_loops, *, facet_filter=None) -> Dict[int, float]:
    sums = _vertex_angle_sums(mesh, facet_filter=facet_filter)
    return {
        idx: float(sum(np.pi - sums.get(int(v), 0.0) for v in loop))
        for idx, loop in enumerate(boundary_loops)
    }


def gauss_bonnet_invariant(mesh, *, facet_filter=None):
    """(G, K_int_total, B_total, per-loop B sums)."""
    boundary_edges = find_boundary_edges(mesh, facet_filter=facet_filter)
    loops = extract_boundary_loops(mesh, boundary_edges)
    boundary_vids = {int(v) for loop in loops for v in loop}
    included_vids = set()
    for fid in _included_facets(mesh, facet_filter):
        included_vids.update(int(v) for v in mesh.facet_vertex_loop(mesh.facets[fid]))
    interior = [v for v in included_vids if v not in boundary_vids]
    deficits = interior_angle_deficit(mesh, interior, facet_filter=facet_filter)
    k_int = float(sum(deficits.values()))
    per_loop = boundary_geodesic_sum(mesh, loops, facet_filter=facet_filter)
    b_total = float(sum(per_loop.values()))
    return k_int + b_total, k_int, b_total, per_loop


@dataclasses.dataclass
class GaussBonnetMonitor:
    """Track the invariant against a baseline with sqrt(N) tolerances."""

    baseline_g: float
    baseline_per_loop_b: Dict[int, float]
    boundary_vertex_count: int
    loop_sizes: Dict[int, int]
    facet_filter: Optional[Callable] = None
    eps_angle: float = 1e-4
    c1: float = 1.0
    c2: float = 1.0

    @classmethod
    def from_mesh(cls, mesh, *, facet_filter=None, eps_angle=1e-4, c1=1.0, c2=1.0):
        g, _k, _b, per_loop = gauss_bonnet_invariant(mesh, facet_filter=facet_filter)
        loops = extract_boundary_loops(
            mesh, find_boundary_edges(mesh, facet_filter=facet_filter)
        )
        return cls(
            baseline_g=g,
            baseline_per_loop_b=per_loop,
            boundary_vertex_count=len({v for loop in loops for v in loop}),
            loop_sizes={i: len(loop) for i, loop in enumerate(loops)},
            facet_filter=facet_filter,
            eps_angle=float(eps_angle),
            c1=float(c1),
            c2=float(c2),
        )

    def evaluate(self, mesh) -> Dict:
        g, k_int, b_total, per_loop = gauss_bonnet_invariant(
            mesh, facet_filter=self.facet_filter
        )
        tol_g = self.c1 * np.sqrt(max(self.boundary_vertex_count, 1)) * self.eps_angle
        drift_g = abs(g - self.baseline_g)
        ok = drift_g <= tol_g
        loop_drifts, loop_tols = {}, {}
        for idx, b in per_loop.items():
            base = self.baseline_per_loop_b.get(idx, b)
            loop_drifts[idx] = abs(b - base)
            loop_tols[idx] = (
                self.c2 * np.sqrt(max(self.loop_sizes.get(idx, 1), 1)) * self.eps_angle
            )
            if loop_drifts[idx] > loop_tols[idx]:
                ok = False
        return {
            "ok": ok,
            "G": g,
            "K_int_total": k_int,
            "B_total": b_total,
            "per_loop_B": per_loop,
            "drift_G": drift_g,
            "drift_B": loop_drifts,
            "tol_G": float(tol_g),
            "tol_B": loop_tols,
        }
