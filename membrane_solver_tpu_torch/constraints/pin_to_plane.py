"""Pin tagged vertices (and endpoints of tagged edges) to a plane.

Counterpart of ``membrane_solver_tpu/constraints/pin_to_plane.py`` in its
``fixed`` mode (per-entity plane from options or global parameters): the
geometric enforcement projects positions onto the plane, including fixed
vertices, and each movable pinned vertex carries one KKT row, the plane
normal at its own row.  The ``slide`` and ``fit`` group modes raise
NotImplementedError when the problem is compiled.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _has(options, name="pin_to_plane"):
    cons = (options or {}).get("constraints")
    return cons == name or (isinstance(cons, list) and name in cons)


def _mode(mesh, options) -> str:
    raw = (options or {}).get("pin_to_plane_mode")
    if raw is None:
        raw = mesh.global_parameters.get("pin_to_plane_mode")
    return str(raw or "fixed").lower()


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
    """Pinned-vertex rows: rows, valid, normal, point, vertex_fixed."""
    mesh = layout.mesh
    entries = []  # (vertex_id, normal|None, point)

    def note(vid, options):
        mode = _mode(mesh, options)
        if mode in {"fit", "slide", "normal", "normal_only", "slide_normal"}:
            raise NotImplementedError(
                f"pin_to_plane_mode={mode!r} is not ported to membrane_solver_tpu_torch"
            )
        entries.append((int(vid), _normal(mesh, options), _point(mesh, options)))

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
    normal_arr = np.tile(np.array([0.0, 0.0, 1.0]), (k, 1))
    point_arr = np.zeros((k, 3))
    vfixed = np.zeros(k, dtype=bool)
    for i, (vid, normal, point) in enumerate(entries):
        rows[i] = layout.row_of[vid]
        valid[i] = True
        if normal is not None:
            normal_arr[i] = normal
        point_arr[i] = point
        vfixed[i] = bool(mesh.vertices[vid].fixed)
    return {
        "rows": rows,
        "valid": valid,
        "normal": normal_arr,
        "point": point_arr,
        "vertex_fixed": vfixed,
    }


def _x(topo, key):
    return topo.extras[f"constraint:pin_to_plane/{key}"]


def enforce(state, topo, params, context: str = "minimize"):
    rows = _x(topo, "rows")
    valid = _x(topo, "valid")
    positions = state.positions
    normals = _x(topo, "normal").to(positions.dtype)
    points = _x(topo, "point").to(positions.dtype)
    pts = positions[rows]
    dist = torch.sum((pts - points) * normals, dim=1)
    proj = pts - dist[:, None] * normals
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
    normals = _x(topo, "normal").to(positions.dtype)
    k = rows.shape[0]
    out = positions.new_zeros((k, positions.shape[0], 3))
    row_idx = torch.arange(k, device=rows.device)
    return out.index_put((row_idx, rows), torch.where(valid[:, None], normals, 0.0),
                         accumulate=True)


def local_constraint_normals(state, topo, params):
    """(Nv, 1, 3) per-vertex constraint normals (the local form of the rows)."""
    rows = _x(topo, "rows")
    valid = _x(topo, "valid") & ~_x(topo, "vertex_fixed")
    positions = state.positions
    normals = _x(topo, "normal").to(positions.dtype)
    nv = positions.shape[0]
    safe = torch.where(valid, rows, nv)
    out = positions.new_zeros((nv + 1, 3))
    out = out.index_add(0, safe, torch.where(valid[:, None], normals, 0.0))
    return out[:nv, None, :]
