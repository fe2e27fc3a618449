"""Equiangulation: Delaunay edge flips on a triangulated mesh.

Copy of ``membrane_solver_tpu/runtime/equiangulation.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``runtime/equiangulation.py`` — flip an interior edge when
the sum of the two opposite angles (measured in a local tangent-plane
projection of the quadrilateral) exceeds pi + 1e-3; flips are applied
sequentially in ascending edge-id order, each validated against normal
inversion (dot(new, old) < -0.5 reverts); iterate passes to convergence
(max 100); fixed edges are never flipped; new diagonal edges take fresh
max+1 ids.

Sequential flips are inherently order-dependent, so this stays a host-side
pass (it runs a handful of times per evolution); the converged Delaunay
property is what downstream physics depends on.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from membrane_solver_tpu_torch.geometry.entities import Edge, Facet
from membrane_solver_tpu_torch.geometry.mesh import Mesh

logger = logging.getLogger("membrane_solver_tpu_torch")

DELAUNAY_MARGIN = 1e-3


def equiangulate_mesh(mesh: Mesh, max_iterations: int = 100) -> Mesh:
    try:
        mesh.build_connectivity_maps()
        mesh.full_mesh_validate()
    except Exception as exc:
        logger.warning("Skipping equiangulation: validation failed before start: %s", exc)
        return mesh

    current = mesh
    for iteration in range(max_iterations):
        new_mesh, changed = equiangulate_iteration(current)
        if not changed:
            try:
                new_mesh.full_mesh_validate()
            except Exception as exc:
                logger.error("Mesh validation failed after equiangulation: %s", exc)
                return mesh
            logger.info("Equiangulation converged in %d iterations", iteration)
            return new_mesh
        current = new_mesh
    logger.warning("Equiangulation reached maximum iterations (%d)", max_iterations)
    try:
        current.full_mesh_validate()
    except Exception as exc:
        logger.error("Mesh validation failed after equiangulation: %s", exc)
        return mesh
    return current


def _bulk_flip_verdicts(mesh: Mesh) -> dict:
    """Vectorized Delaunay verdicts for every interior 2-triangle edge.

    Exactly the arithmetic of :func:`should_flip_edge`, evaluated for all
    candidate edges in one batch.  Positions do not change during
    equiangulation, so a verdict stays valid until a nearby flip modifies
    the edge's adjacent facets — the caller recomputes those few with the
    scalar function, preserving the sequential reference semantics.
    """
    rows = []
    quads = []
    for edge_idx, edge in mesh.edges.items():
        if edge.fixed:
            continue
        adjacent = mesh.facets_of_edge(edge_idx)
        if len(adjacent) != 2:
            continue
        f1, f2 = adjacent
        if len(f1.edge_indices) != 3 or len(f2.edge_indices) != 3:
            continue
        off1 = _off_vertex(mesh, f1, edge)
        off2 = _off_vertex(mesh, f2, edge)
        if off1 is None or off2 is None:
            continue
        rows.append(edge_idx)
        quads.append((edge.tail_index, edge.head_index, off1, off2))
    if not rows:
        return {}
    idx = np.asarray(quads, dtype=np.int64)
    pos = {vid: v.position for vid, v in mesh.vertices.items()}
    P = np.array([[pos[int(a)], pos[int(b)], pos[int(c)], pos[int(d)]] for a, b, c, d in idx])
    p1, p2, q1, q2 = P[:, 0], P[:, 1], P[:, 2], P[:, 3]

    n1 = np.cross(p2 - p1, q1 - p1)
    n2 = np.cross(q2 - p1, p2 - p1)
    n = n1 + n2
    n1n = np.linalg.norm(n1, axis=1)
    nn = np.linalg.norm(n, axis=1)
    n = np.where((nn < 1e-12)[:, None], np.where((n1n >= 1e-12)[:, None], n1, n2), n)
    nn = np.linalg.norm(n, axis=1)
    ok = nn >= 1e-12
    n = n / np.maximum(nn, 1e-300)[:, None]

    edge_vec = p2 - p1
    elen = np.linalg.norm(edge_vec, axis=1)
    ok &= elen >= 1e-12
    u = edge_vec / np.maximum(elen, 1e-300)[:, None]
    v = np.cross(n, u)
    vn = np.linalg.norm(v, axis=1)
    ok &= vn >= 1e-12
    v = v / np.maximum(vn, 1e-300)[:, None]

    def proj(p):
        rel = p - p1
        return np.stack([np.einsum("ij,ij->i", rel, u), np.einsum("ij,ij->i", rel, v)], axis=1)

    a1 = np.zeros((len(rows), 2))
    a2, b1, b2 = proj(p2), proj(q1), proj(q2)

    def angle_at(p, x, y):
        vx, vy = x - p, y - p
        nx = np.linalg.norm(vx, axis=1)
        ny = np.linalg.norm(vy, axis=1)
        good = (nx >= 1e-12) & (ny >= 1e-12)
        cosang = np.einsum("ij,ij->i", vx, vy) / np.maximum(nx * ny, 1e-300)
        return np.arccos(np.clip(cosang, -1.0, 1.0)), good

    th1, g1 = angle_at(b1, a1, a2)
    th2, g2 = angle_at(b2, a1, a2)
    ok &= g1 & g2
    flip = ok & ((th1 + th2) > (np.pi + DELAUNAY_MARGIN))
    return dict(zip(rows, flip.tolist()))


def _update_edge_map_after_flip(
    mesh: Mesh, old_eid: int, new_eid: int, facet1: Facet, facet2: Facet,
    facet_order: dict,
) -> None:
    """Incrementally repair ``edge_to_facets`` after one flip.

    A flip touches exactly six edges (the removed diagonal, the new one,
    and the quad's four boundary edges); a full ``build_connectivity_maps``
    per flip is O(E) and dominated equiangulation wall-clock (~113 us x
    thousands of flips on the cube recipe).  The rebuilt sets here insert
    facet ids in facets-dict order — the SAME insertion sequence a full
    rebuild produces — so the load-bearing raw set-iteration order of
    ``facets_of_edge`` (see its docstring) is preserved bit-for-bit.
    Vertex maps are left stale: equiangulation never reads them, and the
    caller marks the topology dirty so any later consumer rebuilds fully.
    """
    e2f = mesh.edge_to_facets
    e2f.pop(old_eid, None)
    affected = {abs(int(s)) for s in facet1.edge_indices}
    affected |= {abs(int(s)) for s in facet2.edge_indices}
    flipped = (facet1.index, facet2.index)
    for eid in affected:
        members = set(e2f.get(eid, ())) - {facet1.index, facet2.index}
        for fid in flipped:
            if any(abs(int(s)) == eid for s in mesh.facets[fid].edge_indices):
                members.add(fid)
        rebuilt: set = set()
        for fid in sorted(members, key=lambda f: facet_order.get(f, 1 << 30)):
            rebuilt.add(fid)
        e2f[eid] = rebuilt


def equiangulate_iteration(mesh: Mesh) -> Tuple[Mesh, bool]:
    """One pass over all edges; returns (new mesh, any flips applied)."""
    out = mesh.copy_shell()
    out.build_connectivity_maps(force=True)
    # facets are mutated in place during flips (ids stable), so this order
    # map — the insertion order a full rebuild would use — stays valid
    facet_order = {fid: i for i, fid in enumerate(out.facets)}

    changed = False
    next_edge_idx = max(out.edges) + 1 if out.edges else 1
    verdicts = _bulk_flip_verdicts(out)
    dirty: set = set()

    for edge_idx in list(out.edges.keys()):
        if edge_idx not in out.edges:
            continue
        edge = out.edges[edge_idx]
        if edge.fixed:
            continue
        adjacent = out.facets_of_edge(edge_idx)
        if len(adjacent) != 2:
            continue
        facet1, facet2 = adjacent
        if len(facet1.edge_indices) != 3 or len(facet2.edge_indices) != 3:
            continue
        if edge_idx in dirty or edge_idx not in verdicts:
            flip = should_flip_edge(out, edge, facet1, facet2)
        else:
            flip = verdicts[edge_idx]
        if flip:
            touched = {abs(int(s)) for s in facet1.edge_indices}
            touched |= {abs(int(s)) for s in facet2.edge_indices}
            if flip_edge_safe(out, edge_idx, facet1, facet2, next_edge_idx):
                changed = True
                dirty |= touched
                dirty.add(next_edge_idx)
                _update_edge_map_after_flip(
                    out, edge_idx, next_edge_idx, facet1, facet2, facet_order
                )
                next_edge_idx += 1
    if changed:
        # edge_to_facets is exact but the vertex maps were never touched;
        # downstream consumers (vertex_average, refinement, compile_state)
        # must rebuild everything from the flipped topology
        out.mark_topology_changed()
    return out, changed


def _off_vertex(mesh: Mesh, facet: Facet, edge: Edge) -> Optional[int]:
    if len(facet.edge_indices) != 3:
        return None
    verts: set = set()
    for signed_ei in facet.edge_indices:
        e = mesh.get_edge(signed_ei)
        verts.add(e.tail_index)
        verts.add(e.head_index)
    if len(verts) != 3:
        return None
    off = verts - {edge.tail_index, edge.head_index}
    return off.pop() if len(off) == 1 else None


def should_flip_edge(mesh: Mesh, edge: Edge, facet1: Facet, facet2: Facet) -> bool:
    """Delaunay criterion via tangent-plane projection of the quadrilateral."""
    off1 = _off_vertex(mesh, facet1, edge)
    off2 = _off_vertex(mesh, facet2, edge)
    if off1 is None or off2 is None:
        return False

    p1 = mesh.vertices[edge.tail_index].position
    p2 = mesh.vertices[edge.head_index].position
    q1 = mesh.vertices[off1].position
    q2 = mesh.vertices[off2].position

    n1 = np.cross(p2 - p1, q1 - p1)
    n2 = np.cross(q2 - p1, p2 - p1)
    n = n1 + n2
    if np.linalg.norm(n) < 1e-12:
        n = n1 if np.linalg.norm(n1) >= 1e-12 else n2
    n_norm = np.linalg.norm(n)
    if n_norm < 1e-12:
        return False
    n = n / n_norm

    edge_vec = p2 - p1
    edge_len = np.linalg.norm(edge_vec)
    if edge_len < 1e-12:
        return False
    u = edge_vec / edge_len
    v = np.cross(n, u)
    v_norm = np.linalg.norm(v)
    if v_norm < 1e-12:
        return False
    v = v / v_norm

    def proj(p):
        rel = p - p1
        return np.array([np.dot(rel, u), np.dot(rel, v)])

    a1, a2, b1, b2 = np.zeros(2), proj(p2), proj(q1), proj(q2)

    def angle_at(p, x, y):
        vx, vy = x - p, y - p
        nx, ny = np.linalg.norm(vx), np.linalg.norm(vy)
        if nx < 1e-12 or ny < 1e-12:
            return None
        return float(np.arccos(np.clip(np.dot(vx, vy) / (nx * ny), -1.0, 1.0)))

    theta1 = angle_at(b1, a1, a2)
    theta2 = angle_at(b2, a1, a2)
    if theta1 is None or theta2 is None:
        return False
    return (theta1 + theta2) > (np.pi + DELAUNAY_MARGIN)


def _connecting_edge(mesh: Mesh, v1: int, v2: int, candidates) -> Optional[int]:
    for signed_ei in candidates:
        e = mesh.get_edge(signed_ei)
        if {e.tail_index, e.head_index} == {v1, v2}:
            return abs(signed_ei)
    return None


def _oriented(mesh: Mesh, from_v: int, to_v: int, edge_idx: int) -> int:
    e = mesh.edges[edge_idx]
    if e.tail_index == from_v and e.head_index == to_v:
        return edge_idx
    if e.tail_index == to_v and e.head_index == from_v:
        return -edge_idx
    logger.error("Edge %d does not connect %d and %d", edge_idx, from_v, to_v)
    return edge_idx


def flip_edge_safe(
    mesh: Mesh, edge_idx: int, facet1: Facet, facet2: Facet, new_edge_idx: int
) -> bool:
    """Replace the shared edge with the opposite diagonal; revert on bad normals."""
    try:
        edge = mesh.edges[edge_idx]
        v1, v2 = edge.tail_index, edge.head_index
        off1 = _off_vertex(mesh, facet1, edge)
        off2 = _off_vertex(mesh, facet2, edge)
        if off1 is None or off2 is None:
            return False
        try:
            normal1_orig = mesh.facet_normal(facet1)
            normal2_orig = mesh.facet_normal(facet2)
        except ValueError:
            return False

        f1_others = [ei for ei in facet1.edge_indices if abs(ei) != edge_idx]
        f2_others = [ei for ei in facet2.edge_indices if abs(ei) != edge_idx]
        e_v1_off1 = _connecting_edge(mesh, v1, off1, f1_others)
        e_v2_off1 = _connecting_edge(mesh, v2, off1, f1_others)
        e_v1_off2 = _connecting_edge(mesh, v1, off2, f2_others)
        e_v2_off2 = _connecting_edge(mesh, v2, off2, f2_others)
        if None in (e_v1_off1, e_v2_off1, e_v1_off2, e_v2_off2):
            return False

        new_edge = Edge(
            index=new_edge_idx,
            tail_index=off1,
            head_index=off2,
            fixed=edge.fixed,
            options=dict(edge.options),
        )
        # triangle 1: (v1, off1, off2); triangle 2: (v2, off2, off1)
        new_f1 = [
            _oriented(mesh, v1, off1, e_v1_off1),
            new_edge_idx,
            _oriented(mesh, off2, v1, e_v1_off2),
        ]
        new_f2 = [
            _oriented(mesh, v2, off2, e_v2_off2),
            -new_edge_idx,
            _oriented(mesh, off1, v2, e_v2_off1),
        ]

        old_f1_edges = list(facet1.edge_indices)
        old_f2_edges = list(facet2.edge_indices)

        del mesh.edges[edge_idx]
        mesh.edges[new_edge_idx] = new_edge
        facet1.edge_indices = new_f1
        facet2.edge_indices = new_f2

        def revert():
            del mesh.edges[new_edge_idx]
            mesh.edges[edge_idx] = edge
            facet1.edge_indices = old_f1_edges
            facet2.edge_indices = old_f2_edges

        try:
            if (
                np.dot(mesh.facet_normal(facet1), normal1_orig) < -0.5
                or np.dot(mesh.facet_normal(facet2), normal2_orig) < -0.5
            ):
                # benign when sporadic: the reference's sequential flip loop
                # prints the identical reverts on the same edges (verified on
                # the catenoid lane: both solvers revert edges 52..163 during
                # the converged-state `u` and still agree on the final energy)
                logger.warning(
                    "Edge flip created inverted normals, reverting edge %d", edge_idx
                )
                revert()
                return False
        except ValueError:
            revert()
            return False
        return True
    except Exception as exc:  # defensive: never corrupt the mesh on failure
        logger.warning("Edge flip failed for edge %d: %s", edge_idx, exc)
        return False
