"""Mesh refinement: polygonal fan triangulation and 1-to-4 triangle subdivision.

Copy of ``membrane_solver_tpu/runtime/refinement.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``runtime/refinement.py`` —
- ``refine_polygonal_facets`` (refinement.py:58-285): centroid-fan
  triangulation of N-gons with tilt/option inheritance to the centroid.
- ``refine_triangle_mesh`` (refinement.py:287-1133): edge-midpoint 1-to-4
  subdivision (with 1-edge and 2-edge partial cases for no_refine patches),
  midpoint position/tilt averaging, fixed/constraint/preset/pin_to_circle/
  pin_to_plane/disk-tag/rigid-group inheritance, no_refine honoring, and
  body/facet re-indexing.

Topology surgery runs on the host (cheap relative to minimization); the result
is recompiled into padded device arrays without recompiling the jitted step
when capacity suffices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from membrane_solver_tpu_torch.core.ordered_set import OrderedUniqueList
from membrane_solver_tpu_torch.geometry.entities import Body, Edge, Facet, Vertex
from membrane_solver_tpu_torch.geometry.mesh import Mesh, orient_edges_cycle


# ----------------------------------------------------------------------
# option/constraint inheritance helpers
# ----------------------------------------------------------------------
def _merge_constraints(options: dict, additions: List[str]) -> None:
    if not additions:
        return
    existing = options.get("constraints")
    merged = [existing] if isinstance(existing, str) else list(existing or [])
    for item in additions:
        if item not in merged:
            merged.append(item)
    options["constraints"] = merged


def _has_fixed_constraint(options: Optional[dict]) -> bool:
    if not options:
        return False
    if bool(options.get("fixed", False)):
        return True
    cons = options.get("constraints")
    return cons == "fixed" or (isinstance(cons, list) and "fixed" in cons)


def _has_constraint(options: Optional[dict], name: str) -> bool:
    if not options:
        return False
    cons = options.get("constraints")
    return cons == name or (isinstance(cons, list) and name in cons)


def _merge_equal_option(v1_options: dict, v2_options: dict, key: str):
    """(compatible, value): value shared by both endpoints, tolerating one None."""
    a = v1_options.get(key)
    b = v2_options.get(key)
    if a is None and b is None:
        return True, None
    if a is None:
        return True, b
    if b is None:
        return True, a
    if isinstance(a, (list, tuple, np.ndarray)) or isinstance(b, (list, tuple, np.ndarray)):
        try:
            ok = bool(np.allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float)))
        except Exception:
            ok = False
        return ok, (a if ok else None)
    return (a == b), (a if a == b else None)


def _inherit_pin_group(v1_options: dict, v2_options: dict, constraint: str, keys) -> Optional[dict]:
    if not (_has_constraint(v1_options, constraint) and _has_constraint(v2_options, constraint)):
        return None
    merged: dict = {}
    for key in keys:
        ok, val = _merge_equal_option(v1_options, v2_options, key)
        if not ok:
            return None
        if val is not None:
            merged[key] = val
    return merged


_PIN_CIRCLE_KEYS = (
    "pin_to_circle_group",
    "pin_to_circle_mode",
    "pin_to_circle_radius",
    "pin_to_circle_normal",
    "pin_to_circle_point",
)
_PIN_PLANE_KEYS = (
    "pin_to_plane_group",
    "pin_to_plane_mode",
    "pin_to_plane_normal",
    "pin_to_plane_point",
)


def _inherit_pin_to_circle(v1_options: dict, v2_options: dict) -> Optional[dict]:
    merged = _inherit_pin_group(v1_options, v2_options, "pin_to_circle", _PIN_CIRCLE_KEYS)
    if merged is not None:
        preset = v1_options.get("preset")
        if preset is not None and preset == v2_options.get("preset"):
            merged["preset"] = preset
    return merged


def _inherit_pin_to_plane(v1_options: dict, v2_options: dict) -> Optional[dict]:
    return _inherit_pin_group(v1_options, v2_options, "pin_to_plane", _PIN_PLANE_KEYS)


def _inherit_disk_targets(v1_options: dict, v2_options: dict) -> Optional[dict]:
    merged = {}
    for key in ("tilt_disk_target_group_in", "tilt_disk_target_group_out"):
        a, b = v1_options.get(key), v2_options.get(key)
        if a is not None and b is not None and a == b:
            merged[key] = a
    return merged or None


def _inherit_disk_interface_tags(v1_options: dict, v2_options: dict) -> Optional[dict]:
    def disk_group(options: dict) -> Optional[str]:
        for key in ("tilt_thetaB_group_in", "tilt_thetaB_group", "rim_slope_match_group"):
            val = options.get(key)
            if val is not None and str(val).strip() == "disk":
                return "disk"
        return None

    if disk_group(v1_options) != "disk" or disk_group(v2_options) != "disk":
        return None
    merged = {"rim_slope_match_group": "disk", "tilt_thetaB_group_in": "disk"}
    if (
        str(v1_options.get("tilt_thetaB_group") or "") == "disk"
        or str(v2_options.get("tilt_thetaB_group") or "") == "disk"
    ):
        merged["tilt_thetaB_group"] = "disk"
    return merged


def _inherit_rigid_disk_group(v1_options: dict, v2_options: dict) -> Optional[dict]:
    g1, g2 = v1_options.get("rigid_disk_group"), v2_options.get("rigid_disk_group")
    if g1 is None or g2 is None or str(g1) != str(g2):
        return None
    return {"rigid_disk_group": str(g1)}


def _is_ring_like_preset(mesh: Mesh, preset) -> bool:
    if preset is None:
        return False
    opts = (mesh.definitions or {}).get(preset)
    if not isinstance(opts, dict):
        return False
    return any(
        key in opts
        for key in ("pin_to_circle_group", "rim_slope_match_group", "tilt_thetaB_group_in")
    )


def _inherit_preset(mesh: Mesh, v1_options: dict, v2_options: dict) -> Tuple[Optional[str], bool]:
    """Deterministic midpoint preset choice + whether to apply its defaults."""
    p1, p2 = v1_options.get("preset"), v2_options.get("preset")
    if p1 is None and p2 is None:
        return None, False

    def is_disk(p) -> bool:
        return str(p).startswith("disk") if p is not None else False

    ring1, ring2 = _is_ring_like_preset(mesh, p1), _is_ring_like_preset(mesh, p2)
    if p1 is None:
        return (None, False) if ring2 else (p2, True)
    if p2 is None:
        return (None, False) if ring1 else (p1, True)
    if p1 == p2:
        return p1, True
    if ring1 and not ring2:
        return p2, True
    if ring2 and not ring1:
        return p1, True
    if ring1 and ring2:
        if p1 == "disk_edge":
            return p2, False
        if p2 == "disk_edge":
            return p1, False
        return p1, False
    if p1 == "disk_edge":
        return p2, True
    if p2 == "disk_edge":
        return p1, True
    if is_disk(p1) and not is_disk(p2):
        return p2, True
    if is_disk(p2) and not is_disk(p1):
        return p1, True
    return p1, True


def _apply_preset_definitions(mesh: Mesh, options: dict) -> Tuple[dict, bool]:
    preset = options.get("preset")
    defaults = (mesh.definitions or {}).get(preset) if preset else None
    if not isinstance(defaults, dict):
        return options, False
    merged = dict(defaults)
    merged.update(options)

    def as_list(val):
        if val is None:
            return []
        return [val] if isinstance(val, str) else list(val)

    cons = as_list(defaults.get("constraints"))
    for item in as_list(options.get("constraints")):
        if item not in cons:
            cons.append(item)
    if cons:
        merged["constraints"] = cons
    else:
        merged.pop("constraints", None)
    merged.setdefault("preset", preset)
    preset_fixed = bool(defaults.get("fixed", False)) or _has_fixed_constraint(merged)
    return merged, preset_fixed


# ----------------------------------------------------------------------
# polygonal fan triangulation
# ----------------------------------------------------------------------
def refine_polygonal_facets(mesh: Mesh) -> Mesh:
    """Triangulate every non-triangular facet with a centroid fan."""
    out = Mesh()
    out.definitions = dict(mesh.definitions)
    new_vertices = {i: v for i, v in mesh.vertices.items()}
    new_edges = {i: e for i, e in mesh.edges.items()}
    new_facets: Dict[int, Facet] = {}
    next_edge_idx = max(new_edges) + 1 if new_edges else 1
    next_facet_idx = max(mesh.facets) + 1 if mesh.facets else 0
    children: Dict[int, List[int]] = {fid: [] for fid in mesh.facets}

    out.vertices = new_vertices
    out.edges = new_edges

    for fid, facet in mesh.facets.items():
        parent_target_area = facet.options.get("target_area")
        if len(facet.edge_indices) == 3:
            facet.options.setdefault(
                "surface_tension", mesh.global_parameters.get("surface_tension", 1.0)
            )
            new_facets[fid] = facet
            continue

        loop = mesh.facet_vertex_loop(facet)
        if len(loop) < 3:
            continue

        # centroid vertex inherits averaged tilts; options minus facet-only keys
        centroid_pos = np.mean([mesh.vertices[v].position for v in loop], axis=0)
        centroid_idx = max(new_vertices) + 1 if new_vertices else 0
        centroid_options = dict(facet.options)
        for key in ("energy", "surface_tension", "target_area", "parent_facet"):
            centroid_options.pop(key, None)
        loop_verts = [mesh.vertices[v] for v in loop]
        centroid = Vertex(
            index=centroid_idx,
            position=centroid_pos,
            fixed=facet.fixed,
            options=centroid_options,
            tilt=np.mean([v.tilt for v in loop_verts], axis=0),
            tilt_in=np.mean([v.tilt_in for v in loop_verts], axis=0),
            tilt_out=np.mean([v.tilt_out for v in loop_verts], axis=0),
            tilt_fixed=all(v.tilt_fixed for v in loop_verts),
            tilt_fixed_in=all(v.tilt_fixed_in for v in loop_verts),
            tilt_fixed_out=all(v.tilt_fixed_out for v in loop_verts),
        )
        new_vertices[centroid_idx] = centroid

        spokes: Dict[int, Edge] = {}
        for vi in loop:
            spoke = Edge(
                next_edge_idx, vi, centroid_idx, fixed=facet.fixed, options=dict(facet.options)
            )
            if facet.options.get("no_refine", False):
                spoke.options["no_refine"] = True
            new_edges[next_edge_idx] = spoke
            spokes[vi] = spoke
            next_edge_idx += 1

        parent_normal = mesh.facet_normal(facet)
        n = len(loop)
        for i in range(n):
            a, b = loop[i], loop[(i + 1) % n]
            boundary_edge = mesh.get_edge(facet.edge_indices[i])
            child_options = dict(facet.options)
            child_options.pop("target_area", None)
            child_options["surface_tension"] = facet.options.get(
                "surface_tension", mesh.global_parameters.get("surface_tension", 1.0)
            )
            child_options["parent_facet"] = fid
            child_options["constraints"] = facet.options.get("constraints", [])
            raw = [boundary_edge.index, spokes[b].index, -spokes[a].index]
            child = Facet(
                next_facet_idx,
                orient_edges_cycle(raw, out),
                fixed=facet.fixed,
                options=child_options,
            )
            if np.dot(out.facet_normal(child), parent_normal) < 0:
                child.edge_indices = [-ei for ei in reversed(child.edge_indices)]
            new_facets[next_facet_idx] = child
            children[fid].append(next_facet_idx)
            next_facet_idx += 1

        child_ids = children[fid]
        if parent_target_area is not None and child_ids:
            out.facets = new_facets  # for area computation
            areas = [(cid, out.facet_area(new_facets[cid])) for cid in child_ids]
            total = sum(a for _, a in areas)
            if total > 1e-12:
                for cid, a in areas:
                    new_facets[cid].options["target_area"] = parent_target_area * (a / total)

    new_bodies: Dict[int, Body] = {}
    for body in mesh.bodies.values():
        facet_list: List[int] = []
        for fid in body.facet_indices:
            if children.get(fid):
                facet_list.extend(children[fid])
            else:
                facet_list.append(fid)
        idx = len(new_bodies)
        new_bodies[idx] = Body(idx, facet_list, body.target_volume, dict(body.options))

    out.facets = new_facets
    out.bodies = new_bodies
    out.global_parameters = mesh.global_parameters
    out.energy_modules = OrderedUniqueList(mesh.energy_modules)
    out.constraint_modules = OrderedUniqueList(mesh.constraint_modules)
    out.instructions = mesh.instructions
    out.macros = dict(mesh.macros)
    out.mark_topology_changed()
    out.build_connectivity_maps()
    out.project_tilts_to_tangent()
    return out


# ----------------------------------------------------------------------
# 1-to-4 triangle subdivision
# ----------------------------------------------------------------------
def refine_triangle_mesh(mesh: Mesh) -> Mesh:
    out = Mesh()
    # Parity quirk: the reference's refine_triangle_mesh does NOT carry the
    # preset `definitions` over to the new mesh (refinement.py:1109-1121), so
    # preset defaults (e.g. a ring preset's fixed/pin flags) only apply to
    # midpoints during the FIRST refinement after load; later passes keep the
    # preset name but resolve no defaults.  Downstream fixed-vertex sets (and
    # hence vertex averaging and minimization) depend on this.
    out.definitions = {}
    new_vertices = {i: v for i, v in mesh.vertices.items()}
    new_edges: Dict[int, Edge] = {}
    new_facets: Dict[int, Facet] = {}
    edge_midpoints: Dict[Tuple[int, int], Vertex] = {}
    edge_lookup: Dict[Tuple[int, int], Edge] = {}
    facet_children: Dict[int, List[int]] = {}
    next_facet_idx = max(mesh.facets) + 1 if mesh.facets else 0

    mesh.build_connectivity_maps()
    boundary_edge_ids = {
        int(eid) for eid, fids in mesh.edge_to_facets.items() if len(fids) == 1
    }

    out.vertices = new_vertices
    out.edges = new_edges
    out.facets = new_facets
    out.global_parameters = mesh.global_parameters

    def get_or_create_edge(v_from, v_to, parent_edge=None, parent_facet=None) -> Edge:
        key = (min(v_from, v_to), max(v_from, v_to))
        if key in edge_lookup:
            return edge_lookup[key]
        edge = Edge(len(new_edges) + 1, v_from, v_to)
        if parent_edge is not None:
            edge.fixed = parent_edge.fixed
            edge.options = dict(parent_edge.options)
            if edge.fixed:
                new_vertices[v_from].fixed = True
                new_vertices[v_to].fixed = True
        elif parent_facet is not None:
            edge.fixed = parent_facet.fixed
            edge.options = dict(parent_facet.options)
            if parent_facet.options.get("no_refine", False):
                edge.options["no_refine"] = True
        new_edges[edge.index] = edge
        edge_lookup[key] = edge
        return edge

    # which edges get midpoints: edges of refinable facets, not marked no_refine
    refinable_edge_ids: set = set()
    for facet in mesh.facets.values():
        if facet.options.get("no_refine", False):
            continue
        for ei in facet.edge_indices:
            refinable_edge_ids.add(abs(int(ei)))
    edges_to_refine: set = set()
    for eid in refinable_edge_ids:
        if not mesh.edges[eid].options.get("no_refine", False):
            edges_to_refine.add(eid)

    # midpoint vertices (iteration order fixes midpoint id assignment; geometry
    # is order-independent)
    for eid in edges_to_refine:
        edge = mesh.edges[eid]
        va, vb = mesh.vertices[edge.tail_index], mesh.vertices[edge.head_index]
        key = (min(edge.tail_index, edge.head_index), max(edge.tail_index, edge.head_index))
        if key in edge_midpoints:
            continue
        mid_idx = max(new_vertices) + 1 if new_vertices else 0
        mid_options = dict(edge.options)
        v1o = va.options or {}
        v2o = vb.options or {}

        both_fixed = _has_fixed_constraint(v1o) and _has_fixed_constraint(v2o)
        inherit_ring = not ((eid not in boundary_edge_ids) and both_fixed)
        if inherit_ring:
            circ = _inherit_pin_to_circle(v1o, v2o)
            if circ is not None:
                _merge_constraints(mid_options, ["pin_to_circle"])
                mid_options.update(circ)
            plane = _inherit_pin_to_plane(v1o, v2o)
            if plane is not None:
                _merge_constraints(mid_options, ["pin_to_plane"])
                mid_options.update(plane)
        for inherited in (
            _inherit_disk_targets(v1o, v2o),
            _inherit_disk_interface_tags(v1o, v2o),
            _inherit_rigid_disk_group(v1o, v2o),
        ):
            if inherited is not None:
                mid_options.update(inherited)

        preset, apply_defaults = _inherit_preset(mesh, v1o, v2o)
        if preset is not None and not inherit_ring and _is_ring_like_preset(mesh, preset):
            apply_defaults = False
        preset_fixed = False
        if preset is not None:
            mid_options["preset"] = preset
            if apply_defaults:
                mid_options, preset_fixed = _apply_preset_definitions(mesh, mid_options)

        midpoint = Vertex(
            index=mid_idx,
            position=0.5 * (va.position + vb.position),
            fixed=edge.fixed or preset_fixed or _has_fixed_constraint(mid_options),
            options=mid_options,
            tilt=0.5 * (va.tilt + vb.tilt),
            tilt_in=0.5 * (va.tilt_in + vb.tilt_in),
            tilt_out=0.5 * (va.tilt_out + vb.tilt_out),
            tilt_fixed=va.tilt_fixed and vb.tilt_fixed,
            tilt_fixed_in=va.tilt_fixed_in and vb.tilt_fixed_in,
            tilt_fixed_out=va.tilt_fixed_out and vb.tilt_fixed_out,
        )
        new_vertices[mid_idx] = midpoint
        edge_midpoints[key] = midpoint

    def midpoint_of(a, b):
        return edge_midpoints[(min(a, b), max(a, b))].index

    def make_child(raw_edges) -> Facet:
        nonlocal next_facet_idx
        child_opts = dict(facet.options)
        child_opts.pop("target_area", None)
        child = Facet(
            next_facet_idx,
            orient_edges_cycle(raw_edges, out),
            fixed=facet.fixed,
            options=child_opts,
        )
        new_facets[next_facet_idx] = child
        next_facet_idx += 1
        return child

    # subdivide facets (ascending insertion order, like the reference's dict walk)
    for fid, facet in mesh.facets.items():
        oriented = orient_edges_cycle(facet.edge_indices, mesh)
        E0 = mesh.get_edge(oriented[0])
        v0, v1 = E0.endpoints(oriented[0])
        E1 = mesh.get_edge(oriented[1])
        _, v2 = E1.endpoints(oriented[1])
        parent_edges = [mesh.get_edge(abs(ei)) for ei in oriented]
        parent_target_area = facet.options.get("target_area")
        refinable = [abs(ei) in edges_to_refine for ei in oriented]

        if not any(refinable):
            raw = []
            for ei in oriented:
                edge = mesh.get_edge(ei)
                tail, head = edge.endpoints(ei)
                e = get_or_create_edge(tail, head, parent_edge=edge)
                raw.append(e.index if e.tail_index == tail else -e.index)
            child = Facet(
                fid, orient_edges_cycle(raw, out), fixed=facet.fixed, options=dict(facet.options)
            )
            new_facets[fid] = child
            facet_children[fid] = [fid]
            continue

        if v0 == v1 or v1 == v2 or v2 == v0:
            raise ValueError(f"Degenerate triangle: verts {v0},{v1},{v2}")

        m01 = midpoint_of(v0, v1) if refinable[0] else None
        m12 = midpoint_of(v1, v2) if refinable[1] else None
        m20 = midpoint_of(v2, v0) if refinable[2] else None
        parent_normal = mesh.facet_normal(facet)

        if all(refinable):
            # standard 1-to-4
            e1 = get_or_create_edge(v0, m01, parent_edge=parent_edges[0])
            e2 = get_or_create_edge(m01, m20, parent_facet=facet)
            e3 = get_or_create_edge(m20, v0, parent_edge=parent_edges[2])
            f1 = make_child([e1.index, e2.index, e3.index])

            e1 = get_or_create_edge(v1, m12, parent_edge=parent_edges[1])
            e2 = get_or_create_edge(m12, m01, parent_facet=facet)
            e3 = get_or_create_edge(m01, v1, parent_edge=parent_edges[0])
            f2 = make_child([e1.index, e2.index, e3.index])

            e1 = get_or_create_edge(v2, m20, parent_edge=parent_edges[2])
            e2 = get_or_create_edge(m20, m12, parent_facet=facet)
            e3 = get_or_create_edge(m12, v2, parent_edge=parent_edges[1])
            f3 = make_child([e1.index, e2.index, e3.index])

            e1 = get_or_create_edge(m01, m12, parent_facet=facet)
            e2 = get_or_create_edge(m12, m20, parent_facet=facet)
            e3 = get_or_create_edge(m20, m01, parent_facet=facet)
            f4 = make_child([e1.index, e2.index, e3.index])
            child_facets = [f1, f2, f3, f4]

        elif sum(refinable) == 1:
            # split across the single midpoint into 2 triangles
            if refinable[0]:
                tris = [
                    [(v0, m01, parent_edges[0]), (m01, v2, None), (v2, v0, parent_edges[2])],
                    [(m01, v1, parent_edges[0]), (v1, v2, parent_edges[1]), (v2, m01, None)],
                ]
            elif refinable[1]:
                tris = [
                    [(v1, m12, parent_edges[1]), (m12, v0, None), (v0, v1, parent_edges[0])],
                    [(m12, v2, parent_edges[1]), (v2, v0, parent_edges[2]), (v0, m12, None)],
                ]
            else:
                tris = [
                    [(v2, m20, parent_edges[2]), (m20, v1, None), (v1, v2, parent_edges[1])],
                    [(m20, v0, parent_edges[2]), (v0, v1, parent_edges[0]), (v1, m20, None)],
                ]
            child_facets = []
            for spec_edges in tris:
                raw = []
                for (a, b, parent) in spec_edges:
                    e = get_or_create_edge(
                        a, b, parent_edge=parent, parent_facet=None if parent else facet
                    )
                    raw.append(e.index)
                child_facets.append(make_child(raw))

        else:  # sum(refinable) == 2: 1-to-3 with the unsplit edge in one child
            if m01 is None:
                a, b, c = v0, v1, v2
                m_bc, m_ac = m12, m20
                parent_ab, parent_bc, parent_ca = (
                    parent_edges[0],
                    parent_edges[1],
                    parent_edges[2],
                )
            elif m12 is None:
                a, b, c = v1, v2, v0
                m_bc, m_ac = m20, m01
                parent_ab, parent_bc, parent_ca = (
                    parent_edges[1],
                    parent_edges[2],
                    parent_edges[0],
                )
            else:
                a, b, c = v2, v0, v1
                m_bc, m_ac = m01, m12
                parent_ab, parent_bc, parent_ca = (
                    parent_edges[2],
                    parent_edges[0],
                    parent_edges[1],
                )
            e1 = get_or_create_edge(a, b, parent_edge=parent_ab)
            e2 = get_or_create_edge(b, m_bc, parent_edge=parent_bc)
            e3 = get_or_create_edge(m_bc, a, parent_facet=facet)
            f1 = make_child([e1.index, e2.index, e3.index])

            e4 = get_or_create_edge(a, m_bc, parent_facet=facet)
            e5 = get_or_create_edge(m_bc, m_ac, parent_facet=facet)
            e6 = get_or_create_edge(m_ac, a, parent_edge=parent_ca)
            f2 = make_child([e4.index, e5.index, e6.index])

            e7 = get_or_create_edge(m_bc, c, parent_edge=parent_bc)
            e8 = get_or_create_edge(c, m_ac, parent_edge=parent_ca)
            e9 = get_or_create_edge(m_ac, m_bc, parent_facet=facet)
            f3 = make_child([e7.index, e8.index, e9.index])
            child_facets = [f1, f2, f3]

        # keep child orientation aligned with the parent normal
        for child in child_facets:
            if np.dot(out.facet_normal(child), parent_normal) < 0:
                child.edge_indices = [-ei for ei in reversed(child.edge_indices)]
        facet_children[fid] = [f.index for f in child_facets]

        # distribute target area across children proportionally
        child_ids = facet_children[fid]
        if (
            parent_target_area is not None
            and child_ids
            and not (len(child_ids) == 1 and child_ids[0] == fid)
        ):
            areas = [(cid, out.facet_area(new_facets[cid])) for cid in child_ids]
            total = sum(a for _, a in areas)
            if total > 1e-12:
                for cid, a in areas:
                    new_facets[cid].options["target_area"] = parent_target_area * (a / total)

    new_bodies: Dict[int, Body] = {}
    for body in mesh.bodies.values():
        facet_list: List[int] = []
        for fid in body.facet_indices:
            if fid in facet_children:
                facet_list.extend(facet_children[fid])
        idx = len(new_bodies)
        new_bodies[idx] = Body(idx, facet_list, body.target_volume, dict(body.options))

    out.bodies = new_bodies
    out.energy_modules = OrderedUniqueList(mesh.energy_modules)
    out.constraint_modules = OrderedUniqueList(mesh.constraint_modules)
    out.instructions = mesh.instructions
    out.macros = dict(mesh.macros)
    out.mark_topology_changed()
    out.build_connectivity_maps()
    out.project_tilts_to_tangent()
    return out
