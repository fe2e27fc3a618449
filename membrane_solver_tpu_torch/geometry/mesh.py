"""Host-side mesh container.

Copy of ``membrane_solver_tpu/geometry/mesh.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``geometry/mesh.py`` (entity dicts, connectivity maps,
facet vertex loops, SoA views) — but with the ~30 version counters and cache
checks deleted: this mesh is only the *topology/bookkeeping* layer.  Dense
arrays for the device are produced on demand by
:func:`membrane_solver_tpu_torch.device.state.compile_state`, and all hot numerics
are pure functions of those arrays, so stale-cache hazards cannot exist.

Row convention (matches the reference): vertex rows are sorted vertex ids;
triangles are the 3-vertex facet loops in ascending facet id order.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from membrane_solver_tpu_torch.core.exceptions import (
    BodyOrientationError,
    InvalidEdgeIndexError,
)
from membrane_solver_tpu_torch.core.ordered_set import OrderedUniqueList
from membrane_solver_tpu_torch.core.parameters import GlobalParameters
from membrane_solver_tpu_torch.geometry.entities import Body, Edge, Facet, Vertex


class Mesh:
    """Entity mesh: vertices/edges/facets/bodies + run configuration."""

    def __init__(self) -> None:
        self.vertices: Dict[int, Vertex] = {}
        self.edges: Dict[int, Edge] = {}
        self.facets: Dict[int, Facet] = {}
        self.bodies: Dict[int, Body] = {}
        self.global_parameters: GlobalParameters = GlobalParameters()
        self.energy_modules: OrderedUniqueList = OrderedUniqueList()
        self.constraint_modules: OrderedUniqueList = OrderedUniqueList()
        self.instructions: List[str] = []
        self.macros: Dict[str, List[str]] = {}
        self.definitions: Dict[str, Any] = {}
        # connectivity (built on demand)
        self.vertex_to_edges: Dict[int, set] = {}
        self.vertex_to_facets: Dict[int, set] = {}
        self.edge_to_facets: Dict[int, set] = {}
        self._connectivity_dirty = True
        # host-mutation counter: bump after in-place geometry edits so the
        # compiled device state knows to refresh (analog of the reference's
        # mesh version counters, minus the cache layer they drive)
        self._version = 0

    def increment_version(self) -> None:
        self._version += 1

    # ------------------------------------------------------------------
    # entity access
    # ------------------------------------------------------------------
    def get_edge(self, signed_index: int) -> Edge:
        """Return the edge for a signed index (sign = traversal direction)."""
        idx = abs(int(signed_index))
        if idx == 0 or idx not in self.edges:
            raise InvalidEdgeIndexError(f"invalid signed edge index {signed_index}")
        return self.edges[idx]

    def facet_vertex_loop(self, facet: Facet) -> List[int]:
        """Ordered vertex loop implied by the facet's signed edge list."""
        loop: List[int] = []
        for signed_ei in facet.edge_indices:
            tail, _ = self.get_edge(signed_ei).endpoints(signed_ei)
            if not loop or loop[-1] != tail:
                loop.append(tail)
        return loop

    def mark_topology_changed(self) -> None:
        self._connectivity_dirty = True

    # ------------------------------------------------------------------
    # connectivity
    # ------------------------------------------------------------------
    def build_connectivity_maps(self, force: bool = False) -> None:
        if not (self._connectivity_dirty or force):
            return
        self.vertex_to_edges = {}
        self.vertex_to_facets = {}
        self.edge_to_facets = {}
        for edge in self.edges.values():
            for v in (edge.tail_index, edge.head_index):
                self.vertex_to_edges.setdefault(v, set()).add(edge.index)
        for facet in self.facets.values():
            seen: set = set()
            for signed_ei in facet.edge_indices:
                edge = self.get_edge(signed_ei)
                self.edge_to_facets.setdefault(edge.index, set()).add(facet.index)
                seen.add(edge.tail_index)
                seen.add(edge.head_index)
            for v in seen:
                self.vertex_to_facets.setdefault(v, set()).add(facet.index)
        self._connectivity_dirty = False

    def facets_of_edge(self, edge_index: int) -> List[Facet]:
        """Facets adjacent to an edge, in raw set-iteration order.

        NOTE: the order is load-bearing for equiangulation parity — which of
        the two adjacent facets comes first decides the orientation of the
        flipped diagonal triangles and hence whether the flip survives the
        inverted-normal check (reference geometry/mesh.py:892-893 +
        equiangulation.py:359-378).  Do not sort.
        """
        self.build_connectivity_maps()
        return [self.facets[f] for f in self.edge_to_facets.get(abs(edge_index), ())]

    # ------------------------------------------------------------------
    # SoA views (row = position in sorted vertex-id order)
    # ------------------------------------------------------------------
    @property
    def vertex_ids(self) -> np.ndarray:
        return np.array(sorted(self.vertices.keys()), dtype=np.int64)

    @property
    def vertex_index_to_row(self) -> Dict[int, int]:
        return {int(vid): i for i, vid in enumerate(self.vertex_ids)}

    def positions_array(self) -> np.ndarray:
        ids = self.vertex_ids
        out = np.empty((len(ids), 3), dtype=np.float64)
        for i, vid in enumerate(ids):
            out[i] = self.vertices[int(vid)].position
        return out

    def set_positions_array(self, positions: np.ndarray) -> None:
        for i, vid in enumerate(self.vertex_ids):
            self.vertices[int(vid)].position[:] = positions[i]

    def _tilt_array(self, attr: str) -> np.ndarray:
        ids = self.vertex_ids
        out = np.empty((len(ids), 3), dtype=np.float64)
        for i, vid in enumerate(ids):
            out[i] = getattr(self.vertices[int(vid)], attr)
        return out

    def tilts_array(self) -> np.ndarray:
        return self._tilt_array("tilt")

    def tilts_in_array(self) -> np.ndarray:
        return self._tilt_array("tilt_in")

    def tilts_out_array(self) -> np.ndarray:
        return self._tilt_array("tilt_out")

    def set_tilts_array(self, arr: np.ndarray, which: str = "tilt") -> None:
        for i, vid in enumerate(self.vertex_ids):
            getattr(self.vertices[int(vid)], which)[:] = arr[i]

    def fixed_mask(self) -> np.ndarray:
        return np.array([self.vertices[int(v)].fixed for v in self.vertex_ids], dtype=bool)

    # ------------------------------------------------------------------
    # triangles
    # ------------------------------------------------------------------
    def triangle_rows(self) -> tuple[np.ndarray, List[int]]:
        """(n_tri, 3) vertex-row indices for triangular facets, ascending facet id.

        Returns the rows array and the list of contributing facet ids.
        """
        row_of = self.vertex_index_to_row
        rows: List[List[int]] = []
        tri_fids: List[int] = []
        for fid in sorted(self.facets):
            loop = self.facet_vertex_loop(self.facets[fid])
            if len(loop) == 3:
                rows.append([row_of[v] for v in loop])
                tri_fids.append(fid)
        if not rows:
            return np.zeros((0, 3), dtype=np.int32), []
        return np.asarray(rows, dtype=np.int32), tri_fids

    def facet_parameter_array(self, name: str, default: Optional[float] = None) -> np.ndarray:
        """Per-triangle parameter values (facet option else global), ascending facet id."""
        if default is None:
            default = self.global_parameters.get(name, 0.0)
        vals = []
        for fid in sorted(self.facets):
            facet = self.facets[fid]
            if len(self.facet_vertex_loop(facet)) == 3:
                vals.append(float(facet.options.get(name, default)))
        return np.asarray(vals, dtype=np.float64)

    # ------------------------------------------------------------------
    # host-side geometry (small helpers for mesh ops / validation only;
    # hot-path equivalents live in membrane_solver_tpu_torch.device.geo)
    # ------------------------------------------------------------------
    def facet_normal(self, facet: Facet, normalized: bool = True) -> np.ndarray:
        loop = self.facet_vertex_loop(facet)
        verts = self.vertices
        p0 = verts[loop[0]].position
        nx = ny = nz = 0.0
        # hand-rolled fan cross products: np.cross on single 3-vectors pays
        # ~20x ufunc/moveaxis overhead and dominated refine/vertex-average
        prev = verts[loop[1]].position
        ax, ay, az = prev[0] - p0[0], prev[1] - p0[1], prev[2] - p0[2]
        for i in range(2, len(loop)):
            cur = verts[loop[i]].position
            bx, by, bz = cur[0] - p0[0], cur[1] - p0[1], cur[2] - p0[2]
            nx += ay * bz - az * by
            ny += az * bx - ax * bz
            nz += ax * by - ay * bx
            ax, ay, az = bx, by, bz
        n = np.array((0.5 * nx, 0.5 * ny, 0.5 * nz))
        if normalized:
            nn = float(np.sqrt(nx * nx + ny * ny + nz * nz)) * 0.5
            if nn < 1e-15:
                raise ValueError(f"degenerate facet {facet.index}")
            n = n / nn
        return n

    def facet_area(self, facet: Facet) -> float:
        return float(np.linalg.norm(self.facet_normal(facet, normalized=False)))

    def all_facet_areas(self) -> Dict[int, float]:
        """{facet id: area}, vectorized over the triangle batch (mesh ops
        call this per smoothing/flip pass; the per-facet loop was a host
        hotspot at refined sizes)."""
        rows, tri_fids = self.triangle_rows()
        out: Dict[int, float] = {}
        if len(tri_fids):
            p = self.positions_array()[np.asarray(rows)]
            n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            areas = 0.5 * np.sqrt(np.sum(n * n, axis=1))
            out = {int(fid): float(a) for fid, a in zip(tri_fids, areas)}
        for fid, facet in self.facets.items():
            if fid not in out:
                out[fid] = self.facet_area(facet)
        return out

    def body_volume(self, body: Body) -> float:
        """Divergence-theorem volume sum(v0 . (v1 x v2))/6 over facet fans."""
        total = 0.0
        for fid in body.facet_indices:
            loop = self.facet_vertex_loop(self.facets[fid])
            pts = np.array([self.vertices[v].position for v in loop])
            v1 = pts[1:-1]
            v2 = pts[2:]
            total += float(np.dot(np.cross(v1, v2), pts[0]).sum()) / 6.0
        return total

    def compute_total_surface_area(self) -> float:
        return float(sum(self.facet_area(f) for f in self.facets.values()))

    def compute_total_volume(self) -> float:
        return float(sum(self.body_volume(b) for b in self.bodies.values()))

    def min_edge_length(self) -> float:
        if not self.edges:
            return 0.0
        pos = {v.index: v.position for v in self.vertices.values()}
        lengths = [
            float(np.linalg.norm(pos[e.head_index] - pos[e.tail_index]))
            for e in self.edges.values()
        ]
        return min(lengths) if lengths else 0.0

    # ------------------------------------------------------------------
    # tilt handling
    # ------------------------------------------------------------------
    def vertex_normals_host(self) -> Dict[int, np.ndarray]:
        """Area-weighted vertex normals (host numpy; used by tilt projection)."""
        self.build_connectivity_maps()
        accum: Dict[int, np.ndarray] = {v: np.zeros(3) for v in self.vertices}
        for facet in self.facets.values():
            loop = self.facet_vertex_loop(facet)
            if len(loop) < 3:
                continue
            n = self.facet_normal(facet, normalized=False)
            for v in loop:
                accum[v] += n
        for v, n in accum.items():
            nn = np.linalg.norm(n)
            accum[v] = n / nn if nn > 1e-15 else n
        return accum

    def project_tilts_to_tangent(self) -> None:
        """Project all three tilt fields into each vertex's tangent plane."""
        if not self.facets:
            return
        if not any(
            np.any(v.tilt) or np.any(v.tilt_in) or np.any(v.tilt_out)
            for v in self.vertices.values()
        ):
            return
        normals = self.vertex_normals_host()
        for vid, vertex in self.vertices.items():
            n = normals.get(vid)
            if n is None or not np.any(n):
                continue
            for attr in ("tilt", "tilt_in", "tilt_out"):
                t = getattr(vertex, attr)
                t -= np.dot(t, n) * n

    def initialize_tilts_from_options(self) -> None:
        for vertex in self.vertices.values():
            opts = vertex.options
            for key, attr in (("tilt", "tilt"), ("tilt_in", "tilt_in"), ("tilt_out", "tilt_out")):
                raw = opts.get(key)
                if raw is not None:
                    arr = np.asarray(raw, dtype=float)
                    if arr.shape == (2,):
                        arr = np.array([arr[0], arr[1], 0.0])
                    getattr(vertex, attr)[:] = arr

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def validate_edge_indices(self) -> None:
        for facet in self.facets.values():
            prev_head = None
            for signed_ei in facet.edge_indices:
                edge = self.get_edge(signed_ei)  # raises on bad index
                tail, head = edge.endpoints(signed_ei)
                if prev_head is not None and tail != prev_head:
                    raise InvalidEdgeIndexError(
                        f"facet {facet.index}: edge loop discontinuous at edge {signed_ei}"
                    )
                prev_head = head
            if facet.edge_indices:
                first_tail, _ = self.get_edge(facet.edge_indices[0]).endpoints(
                    facet.edge_indices[0]
                )
                if prev_head != first_tail:
                    raise InvalidEdgeIndexError(f"facet {facet.index}: edge loop not closed")

    def full_mesh_validate(self) -> None:
        self.validate_edge_indices()
        for facet in self.facets.values():
            loop = self.facet_vertex_loop(facet)
            if len(set(loop)) != len(loop):
                raise InvalidEdgeIndexError(
                    f"facet {facet.index}: repeated vertex in loop {loop}"
                )

    def validate_body_orientation(self, repair: bool = False) -> None:
        """Require each closed body to have positive signed volume.

        With ``repair=True``, flip all facet loops of an inverted body instead
        of raising.
        """
        for body in self.bodies.values():
            vol = self.body_volume(body)
            if vol < 0:
                if repair:
                    for fid in body.facet_indices:
                        facet = self.facets[fid]
                        facet.edge_indices = [-ei for ei in reversed(facet.edge_indices)]
                    self.mark_topology_changed()
                else:
                    raise BodyOrientationError(
                        f"body {body.index} has negative volume {vol:.6g}; "
                        "facet orientations are inward-facing",
                        mesh=self,
                        body_index=body.index,
                    )

    # ------------------------------------------------------------------
    # copying
    # ------------------------------------------------------------------
    def copy_shell(self) -> "Mesh":
        """New mesh sharing global parameters, copying entities and run config."""
        out = Mesh()
        out.vertices = {i: v.copy() for i, v in self.vertices.items()}
        out.edges = {i: e.copy() for i, e in self.edges.items()}
        out.facets = {i: f.copy() for i, f in self.facets.items()}
        out.bodies = {i: b.copy() for i, b in self.bodies.items()}
        out.global_parameters = self.global_parameters
        out.energy_modules = self.energy_modules.copy()
        out.constraint_modules = self.constraint_modules.copy()
        out.instructions = list(self.instructions)
        out.macros = dict(self.macros)
        # Parity quirk: the reference's equiangulate_iteration rebuilds the
        # mesh without carrying `definitions` (equiangulation.py:85-98), so
        # preset defaults stop resolving after the first flip pass, exactly
        # like refine_triangle_mesh.  Keep that behavior.
        out.definitions = {}
        return out

    def __repr__(self) -> str:
        return (
            f"Mesh(V={len(self.vertices)}, E={len(self.edges)}, "
            f"F={len(self.facets)}, B={len(self.bodies)})"
        )


def orient_edges_cycle(edge_indices: Iterable[int], mesh: Mesh) -> List[int]:
    """Reorder/sign a set of edges into a continuous cycle.

    Parity: reference ``runtime/refinement.py:orient_edges_cycle`` — the first
    edge is always forced to POSITIVE orientation (traversed tail->head), even
    if the facet listed it negatively, so the produced cycle's winding follows
    the first edge's raw direction.  Downstream child-facet construction and
    the vertex-average restoration walk depend on this choice.
    """
    edges = list(edge_indices)
    if not edges:
        return []
    first = abs(edges[0])
    result = [first]
    current_head = mesh.get_edge(first).head_index
    remaining = edges[1:]
    while remaining:
        for i, cand in enumerate(remaining):
            tail, head = mesh.get_edge(cand).endpoints(cand)
            if tail == current_head:
                result.append(cand)
                current_head = head
                remaining.pop(i)
                break
            if head == current_head:
                result.append(-cand)
                current_head = tail
                remaining.pop(i)
                break
        else:
            raise InvalidEdgeIndexError(f"cannot orient edge cycle from {edges}")
    return result
