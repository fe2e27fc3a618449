"""Pin tagged vertices (and endpoints of tagged edges) to a plane.

Counterpart of ``membrane_solver_tpu/constraints/pin_to_plane.py``.  Modes
(``pin_to_plane_mode``, per entity or global):

- ``fixed``: the entity's plane (``pin_to_plane_normal``, ``pin_to_plane_point``);
  the geometric enforcement projects its vertices, fixed ones included;
- ``slide`` (aliases ``normal``, ``normal_only``, ``slide_normal``): the
  group's (``pin_to_plane_group``) given normal through the centroid of the
  group's current positions;
- ``fit``: the group's least-squares plane (the smallest eigenvector of its
  scatter matrix, once the group has three members) through its centroid.
  A group with any ``fit`` member fits; its first given normal is the
  normal of a slide group.

The group modes skip fixed vertices when they project.  Each movable
pinned vertex carries one KKT row, its plane's normal at its own row.  The
group tables are compiled only when some entity selects a group mode; the
group sums add in a fixed order (``_pin_groups.group_sums``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.constraints._pin_groups import group_sums
from membrane_solver_tpu_torch.device import linalg as dlinalg
from membrane_solver_tpu_torch.device.state import kept_slot_csr
from membrane_solver_tpu_torch.kernels import vertex_sum

MODE_FIXED = 0
MODE_SLIDE = 1
MODE_FIT = 2


def _has(options, name="pin_to_plane"):
    cons = (options or {}).get("constraints")
    return cons == name or (isinstance(cons, list) and name in cons)


def _mode_code(mesh, options) -> int:
    raw = (options or {}).get("pin_to_plane_mode")
    if raw is None:
        raw = mesh.global_parameters.get("pin_to_plane_mode")
    mode = str(raw or "fixed").lower()
    if mode == "fit":
        return MODE_FIT
    if mode in {"slide", "normal", "normal_only", "slide_normal"}:
        return MODE_SLIDE
    return MODE_FIXED


def _normal(mesh, options):
    raw = (options or {}).get("pin_to_plane_normal")
    if raw is None:
        raw = mesh.global_parameters.get("pin_to_plane_normal")
    if raw is None:
        return None
    n = np.asarray(raw, dtype=float)
    nn = np.linalg.norm(n)
    return n / nn if nn > 1e-15 else None


def _point(mesh, options):
    raw = (options or {}).get("pin_to_plane_point")
    if raw is None:
        raw = mesh.global_parameters.get("pin_to_plane_point")
    return np.asarray(raw, dtype=float) if raw is not None else np.zeros(3)


def compile_topology(layout) -> dict:
    """Pinned-entry rows: rows, valid, normal, point, vertex_fixed; with group modes also
    mode, group and the group tables group_mode, group_normal, group_has_normal."""
    mesh = layout.mesh
    entries = []  # (vertex_id, mode, normal|None, point, group name)
    group_names: dict = {}

    def note(vid, options):
        mode = _mode_code(mesh, options)
        group = str((options or {}).get("pin_to_plane_group") or "default")
        entries.append((int(vid), mode, _normal(mesh, options), _point(mesh, options), group))
        if mode != MODE_FIXED:
            group_names.setdefault(group, len(group_names))

    for vid, vertex in mesh.vertices.items():
        if _has(vertex.options):
            note(vid, vertex.options)
    for edge in mesh.edges.values():
        if _has(edge.options):
            note(edge.tail_index, edge.options)
            note(edge.head_index, edge.options)

    k = max(len(entries), 1)
    rows = np.zeros(k, dtype=np.int64)
    valid = np.zeros(k, dtype=bool)
    mode_arr = np.zeros(k, dtype=np.int64)
    normal_arr = np.tile(np.array([0.0, 0.0, 1.0]), (k, 1))
    point_arr = np.zeros((k, 3))
    group_arr = np.zeros(k, dtype=np.int64)
    vfixed = np.zeros(k, dtype=bool)
    for i, (vid, mode, normal, point, group) in enumerate(entries):
        rows[i] = layout.row_of[vid]
        valid[i] = True
        mode_arr[i] = mode
        if normal is not None:
            normal_arr[i] = normal
        point_arr[i] = point
        group_arr[i] = group_names.get(group, 0)
        vfixed[i] = bool(mesh.vertices[vid].fixed)
    out = {"rows": rows, "valid": valid, "normal": normal_arr, "point": point_arr,
           "vertex_fixed": vfixed}
    if not group_names:
        return out
    # merge group metadata: the mode escalates to fit, the first given normal wins
    g_count = len(group_names)
    group_mode = np.zeros(g_count, dtype=np.int64)
    group_normal = np.tile(np.array([0.0, 0.0, 1.0]), (g_count, 1))
    group_has_normal = np.zeros(g_count, dtype=bool)
    for (_vid, mode, normal, _pt, group) in entries:
        if mode == MODE_FIXED:
            continue
        g = group_names[group]
        group_mode[g] = max(group_mode[g], mode)
        if normal is not None and not group_has_normal[g]:
            group_normal[g] = normal
            group_has_normal[g] = True
    out.update(mode=mode_arr, group=group_arr, group_mode=group_mode,
               group_normal=group_normal, group_has_normal=group_has_normal)
    return out


def _x(topo, key):
    return topo.extras[f"constraint:pin_to_plane/{key}"]


def _has_groups(topo) -> bool:
    return "constraint:pin_to_plane/group_mode" in topo.extras


def _group_planes(positions, topo):
    """(G, 3) unit normals and (G, 3) centroids of the slide and fit groups."""
    dtype = positions.dtype
    rows, group = _x(topo, "rows"), _x(topo, "group")
    keep = _x(topo, "valid") & (_x(topo, "mode") != MODE_FIXED)
    g_mode = _x(topo, "group_mode")
    g_count = g_mode.shape[0]
    key = "constraint:pin_to_plane/group_sums"
    pts = positions[rows]
    first = group_sums(torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1), topo, key + "/1",
                       group, keep, g_count)
    counts = first[:, 3]
    centroids = first[:, :3] / torch.clamp(counts, min=1.0)[:, None]
    centered = pts - centroids[group]
    outer = (centered[:, :, None] * centered[:, None, :]).reshape(-1, 9)
    cov = group_sums(outer, topo, key + "/9", group, keep, g_count).reshape(g_count, 3, 3)
    fit_normals = torch.stack([dlinalg.smallest_eigvec_3x3(cov[g]) for g in range(g_count)])
    base = _x(topo, "group_normal").to(dtype)
    use_fit = (g_mode == MODE_FIT) & (counts >= 3)
    normals = torch.where(use_fit[:, None], fit_normals, base)
    normals = normals / torch.clamp(torch.linalg.vector_norm(normals, dim=1, keepdim=True),
                                    min=1e-15)
    return normals, centroids


def _entry_planes(positions, topo):
    """Per entry (normal, point, projected): its own plane in fixed mode, its group's otherwise."""
    normals = _x(topo, "normal").to(positions.dtype)
    points = _x(topo, "point").to(positions.dtype)
    if not _has_groups(topo):
        return normals, points, _x(topo, "valid")
    g_normals, g_points = _group_planes(positions, topo)
    group = _x(topo, "group")
    is_fixed_mode = _x(topo, "mode") == MODE_FIXED
    normals = torch.where(is_fixed_mode[:, None], normals, g_normals[group])
    points = torch.where(is_fixed_mode[:, None], points, g_points[group])
    # the group modes leave fixed vertices where they are
    use = _x(topo, "valid") & (is_fixed_mode | ~_x(topo, "vertex_fixed"))
    return normals, points, use


def enforce(state, topo, params, context: str = "minimize"):
    rows = _x(topo, "rows")
    valid = _x(topo, "valid")
    positions = state.positions
    normals, points, use = _entry_planes(positions, topo)
    pts = positions[rows]
    dist = torch.sum((pts - points) * normals, dim=1)
    proj = torch.where(use[:, None], pts - dist[:, None] * normals, pts)
    # invalid (padding) entries are dropped: they write into a scratch row
    nv = positions.shape[0]
    safe_rows = torch.where(valid, rows, nv)
    ext = torch.cat([positions, positions.new_zeros((1, 3))])
    ext = ext.index_put((safe_rows,), torch.where(valid[:, None], proj, 0.0))
    return dataclasses.replace(state, positions=ext[:nv])


def constraint_gradient_rows(state, topo, params):
    """(K, Nv, 3): one KKT row per movable pinned vertex with its plane normal."""
    rows = _x(topo, "rows")
    valid = _x(topo, "valid") & ~_x(topo, "vertex_fixed")
    positions = state.positions
    normals = _entry_planes(positions, topo)[0]
    k = rows.shape[0]
    out = positions.new_zeros((k, positions.shape[0], 3))
    row_idx = torch.arange(k, device=rows.device)
    return out.index_put((row_idx, rows), torch.where(valid[:, None], normals, 0.0))


def local_constraint_normals(state, topo, params):
    """(Nv, 1, 3) per-vertex constraint normals (the local form of the rows).

    A vertex pinned twice (itself and through an edge, or through two
    edges) sums its normals, in a fixed order (``vertex_sum.row_sum``).
    """
    valid = _x(topo, "valid") & ~_x(topo, "vertex_fixed")
    positions = state.positions
    normals = _entry_planes(positions, topo)[0]
    csr = kept_slot_csr(topo, "constraint:pin_to_plane/normals", _x(topo, "rows"),
                        positions.shape[0], keep=valid)
    out = vertex_sum.row_sum(torch.where(valid[:, None], normals, 0.0), csr)
    return out[:, None, :]
