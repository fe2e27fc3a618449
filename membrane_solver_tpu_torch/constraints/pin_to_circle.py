"""Pin tagged vertices (and endpoints of tagged edges) to a circle.

Counterpart of ``membrane_solver_tpu/constraints/pin_to_circle.py`` in its
``fixed`` mode: circle = (plane normal, center point, radius) per entity or
from the global parameters.  The geometric enforcement projects every
tagged vertex onto its circle, including fixed vertices; groups listed in
``pin_to_circle_mesh_operation_preserve_normal_groups`` keep their normal
offset in the mesh_operation and finalize contexts.  Each movable pinned
vertex carries two KKT rows (plane normal and radial direction).  The
``fit`` and ``slide`` group modes raise NotImplementedError when the
problem is compiled.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _has(options):
    cons = (options or {}).get("constraints")
    return cons == "pin_to_circle" or (isinstance(cons, list) and "pin_to_circle" in cons)


def _pick(mesh, options, key, default=None):
    val = (options or {}).get(key)
    if val is None:
        val = mesh.global_parameters.get(key)
    return default if val is None else val


def compile_topology(layout) -> dict:
    mesh = layout.mesh
    entries = []  # (vid, normal, center, radius, preserve)

    preserve_raw = mesh.global_parameters.get(
        "pin_to_circle_mesh_operation_preserve_normal_groups"
    )
    if preserve_raw is None:
        preserve_set = set()
    elif isinstance(preserve_raw, str):
        preserve_set = {preserve_raw.strip()}
    else:
        preserve_set = {str(x).strip() for x in preserve_raw}

    def note(vid, options):
        mode = str(_pick(mesh, options, "pin_to_circle_mode") or "fixed").lower()
        if mode in {"fit", "slide", "normal", "normal_only", "slide_normal"}:
            raise NotImplementedError(
                f"pin_to_circle_mode={mode!r} is not ported to membrane_solver_tpu_torch"
            )
        group = str(_pick(mesh, options, "pin_to_circle_group", "default") or "default")
        normal = np.asarray(_pick(mesh, options, "pin_to_circle_normal", [0, 0, 1]), dtype=float)
        nn = np.linalg.norm(normal)
        if nn < 1e-15:
            return
        center = np.asarray(_pick(mesh, options, "pin_to_circle_point", [0, 0, 0]), dtype=float)
        radius = float(_pick(mesh, options, "pin_to_circle_radius", 1.0))
        if radius <= 0:
            return
        entries.append((int(vid), normal / nn, center, radius, group in preserve_set))

    for vid, vertex in mesh.vertices.items():
        if _has(vertex.options):
            note(vid, vertex.options)
    for edge in mesh.edges.values():
        if _has(edge.options):
            note(edge.tail_index, edge.options)
            note(edge.head_index, edge.options)

    # duplicates preserved: per-entity projection and per-duplicate KKT rows
    k = max(len(entries), 1)
    f_rows = np.zeros(k, dtype=np.int64)
    f_valid = np.zeros(k, dtype=bool)
    f_normal = np.tile(np.array([0.0, 0.0, 1.0]), (k, 1))
    f_center = np.zeros((k, 3))
    f_radius = np.ones(k)
    f_preserve = np.zeros(k, dtype=bool)
    f_vfixed = np.zeros(k, dtype=bool)
    for i, (vid, normal, center, radius, preserve) in enumerate(entries):
        f_rows[i] = layout.row_of[vid]
        f_valid[i] = True
        f_normal[i] = normal
        f_center[i] = center
        f_radius[i] = radius
        f_preserve[i] = preserve
        f_vfixed[i] = bool(mesh.vertices[vid].fixed)
    return {
        "f_rows": f_rows,
        "f_valid": f_valid,
        "f_normal": f_normal,
        "f_center": f_center,
        "f_radius": f_radius,
        "f_preserve": f_preserve,
        "f_vfixed": f_vfixed,
    }


def _x(topo, key):
    return topo.extras[f"constraint:pin_to_circle/{key}"]


def _table(topo, dtype):
    return (
        _x(topo, "f_rows"),
        _x(topo, "f_normal").to(dtype),
        _x(topo, "f_center").to(dtype),
    )


def _default_tangent(normal):
    cond = (torch.abs(normal[..., 0]) > 0.9)[..., None]
    trial = torch.where(
        cond,
        torch.tensor([0.0, 1.0, 0.0], dtype=normal.dtype, device=normal.device),
        torch.tensor([1.0, 0.0, 0.0], dtype=normal.dtype, device=normal.device),
    )
    t = trial - torch.sum(trial * normal, dim=-1, keepdim=True) * normal
    n = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    return torch.where(n > 1e-15, t / torch.clamp(n, min=1e-15), trial)


def enforce(state, topo, params, context: str = "minimize"):
    positions = state.positions
    rows, normal, center = _table(topo, positions.dtype)
    valid = _x(topo, "f_valid")
    radius = _x(topo, "f_radius").to(positions.dtype)
    pts = positions[rows]
    off_n = torch.sum((pts - center) * normal, dim=1)
    pos_plane = pts - off_n[:, None] * normal
    offset = pos_plane - center
    onorm = torch.linalg.vector_norm(offset, dim=1)
    tangent = torch.where(
        onorm[:, None] > 1e-15,
        offset / torch.clamp(onorm, min=1e-15)[:, None],
        _default_tangent(normal),
    )
    projected = center + radius[:, None] * tangent
    if context in {"mesh_operation", "finalize"}:
        keep_normal = _x(topo, "f_preserve")
        projected = torch.where(
            keep_normal[:, None], projected + off_n[:, None] * normal, projected
        )
    # invalid entries write into a scratch row, which is dropped
    nv = positions.shape[0]
    safe_rows = torch.where(valid, rows, nv)
    ext = torch.cat([positions, positions.new_zeros((1, 3))])
    ext = ext.index_put((safe_rows,), torch.where(valid[:, None], projected, 0.0))
    return dataclasses.replace(state, positions=ext[:nv])


def _normal_pairs(positions, topo):
    """(rows, valid, plane normal, radial direction) per movable entry."""
    rows, normal, center = _table(topo, positions.dtype)
    valid = _x(topo, "f_valid") & ~_x(topo, "f_vfixed")
    pts = positions[rows]
    pos_plane = pts - torch.sum((pts - center) * normal, dim=1, keepdim=True) * normal
    radial = pos_plane - center
    rnorm = torch.linalg.vector_norm(radial, dim=1)
    radial_hat = torch.where(
        rnorm[:, None] > 1e-15,
        radial / torch.clamp(rnorm, min=1e-15)[:, None],
        _default_tangent(normal),
    )
    return rows, valid, normal, radial_hat


def constraint_gradient_rows(state, topo, params):
    """Two KKT rows (plane + radial) per movable pinned vertex: (2K, Nv, 3)."""
    positions = state.positions
    rows, valid, normal, radial_hat = _normal_pairs(positions, topo)
    k = rows.shape[0]
    out = positions.new_zeros((2 * k, positions.shape[0], 3))
    idx = torch.arange(k, device=rows.device)
    out = out.index_put((2 * idx, rows), torch.where(valid[:, None], normal, 0.0),
                        accumulate=True)
    return out.index_put((2 * idx + 1, rows), torch.where(valid[:, None], radial_hat, 0.0),
                         accumulate=True)


def local_constraint_normals(state, topo, params):
    """(Nv, 2, 3) per-vertex normals (plane + radial)."""
    positions = state.positions
    rows, valid, normal, radial_hat = _normal_pairs(positions, topo)
    pair = torch.stack([normal.expand_as(radial_hat), radial_hat], dim=1)
    pair = torch.where(valid[:, None, None], pair, 0.0)
    nv = positions.shape[0]
    safe = torch.where(valid, rows, nv)
    out = positions.new_zeros((nv + 1, 2, 3))
    return out.index_add(0, safe, pair)[:nv]
