"""Pin tagged vertices (and endpoints of tagged edges) to a circle.

Counterpart of ``membrane_solver_tpu/constraints/pin_to_circle.py``.  Modes
(``pin_to_circle_mode``, per entity or global):

- ``fixed``: circle = (plane normal, center point, radius) per entity or
  from the global parameters;
- ``slide`` (aliases ``normal``, ``normal_only``, ``slide_normal``): the
  group's (``pin_to_circle_group``) center moves along its normal to the
  members' mean offset from the given point, and the radius is the
  members' mean in-plane distance from that center;
- ``fit``: the algebraic least-squares circle of the members in the
  group's plane through their centroid.

A group takes its members' first given normal (else the smallest
eigenvector of its scatter matrix), point and radius (a given radius
replaces the fitted one); a group with fewer than three members is not
projected.  The geometric enforcement projects every tagged vertex onto
its circle, including fixed vertices; groups listed in
``pin_to_circle_mesh_operation_preserve_normal_groups`` keep their normal
offset in the mesh_operation and finalize contexts.  Each movable pinned
vertex carries two KKT rows (plane normal and radial direction).  The
group sums add in a fixed order (``_pin_groups.group_sums``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.constraints._pin_groups import group_sums
from membrane_solver_tpu_torch.device import linalg as dlinalg
from membrane_solver_tpu_torch.device.reduce import per_member
from membrane_solver_tpu_torch.device.state import kept_slot_csr
from membrane_solver_tpu_torch.kernels import vertex_sum

MODE_FIXED = 0
MODE_SLIDE = 1
MODE_FIT = 2


def _has(options):
    cons = (options or {}).get("constraints")
    return cons == "pin_to_circle" or (isinstance(cons, list) and "pin_to_circle" in cons)


def _mode_code(mesh, options) -> int:
    raw = (options or {}).get("pin_to_circle_mode")
    if raw is None:
        raw = mesh.global_parameters.get("pin_to_circle_mode")
    mode = str(raw or "fixed").lower()
    if mode == "fit":
        return MODE_FIT
    if mode in {"slide", "normal", "normal_only", "slide_normal"}:
        return MODE_SLIDE
    return MODE_FIXED


def _pick(mesh, options, key, default=None):
    val = (options or {}).get(key)
    if val is None:
        val = mesh.global_parameters.get(key)
    return default if val is None else val


def compile_topology(layout) -> dict:
    """The fixed-mode entries (``f_*``) and, with group modes, the members (``m_*``) and groups (``g_*``)."""
    mesh = layout.mesh
    entries = []  # (vid, normal, center, radius, preserve)
    group_names: dict = {}
    group_members: dict = {}
    group_meta: dict = {}

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
        mode = _mode_code(mesh, options)
        group = str(_pick(mesh, options, "pin_to_circle_group", "default") or "default")
        if mode != MODE_FIXED:
            g = group_names.setdefault(group, len(group_names))
            group_members.setdefault(g, set()).add(int(vid))
            meta = group_meta.setdefault(g, {"mode": mode, "normal": None, "radius": None,
                                             "point": None, "preserve": group in preserve_set})
            meta["mode"] = mode
            for key, mkey in (("pin_to_circle_normal", "normal"),
                              ("pin_to_circle_radius", "radius"),
                              ("pin_to_circle_point", "point")):
                if meta[mkey] is None:
                    val = _pick(mesh, options, key)
                    if val is not None:
                        meta[mkey] = float(val) if mkey == "radius" else np.asarray(val, float)
            return
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
    out = {
        "f_rows": f_rows,
        "f_valid": f_valid,
        "f_normal": f_normal,
        "f_center": f_center,
        "f_radius": f_radius,
        "f_preserve": f_preserve,
        "f_vfixed": f_vfixed,
    }
    if not group_names:
        return out
    # the group members, each vertex once per group, by group then vertex id
    members = [(g, layout.row_of[vid], bool(mesh.vertices[vid].fixed))
               for g in sorted(group_members) for vid in sorted(group_members[g])]
    g_count = len(group_names)
    g_mode = np.zeros(g_count, dtype=np.int64)
    g_normal = np.tile(np.array([0.0, 0.0, 1.0]), (g_count, 1))
    g_has_normal = np.zeros(g_count, dtype=bool)
    g_radius = np.ones(g_count)
    g_has_radius = np.zeros(g_count, dtype=bool)
    g_point = np.zeros((g_count, 3))
    g_preserve = np.zeros(g_count, dtype=bool)
    for g, meta in group_meta.items():
        g_mode[g] = meta["mode"]
        if meta["normal"] is not None:
            nn = np.linalg.norm(meta["normal"])
            if nn > 1e-15:
                g_normal[g] = meta["normal"] / nn
                g_has_normal[g] = True
        if meta["radius"] is not None:
            g_radius[g] = meta["radius"]
            g_has_radius[g] = True
        if meta["point"] is not None:
            g_point[g] = meta["point"]
        g_preserve[g] = meta["preserve"]
    out.update(
        m_group=np.array([m[0] for m in members], dtype=np.int64),
        m_rows=np.array([m[1] for m in members], dtype=np.int64),
        m_valid=np.ones(len(members), dtype=bool),
        m_vfixed=np.array([m[2] for m in members], dtype=bool),
        g_mode=g_mode, g_normal=g_normal, g_has_normal=g_has_normal, g_radius=g_radius,
        g_has_radius=g_has_radius, g_point=g_point, g_preserve=g_preserve,
    )
    return out


def _x(topo, key):
    return topo.extras[f"constraint:pin_to_circle/{key}"]


def _has_groups(topo) -> bool:
    return "constraint:pin_to_circle/g_mode" in topo.extras


def _default_tangent(normal):
    """A unit vector in the plane of ``normal``: x, or y where |n_x| > 0.9, less its normal part.

    The trial axes are built on the device (no host-to-device copy).
    """
    cond = torch.abs(normal[..., 0]) > 0.9
    one, zero = torch.ones_like(normal[..., 0]), torch.zeros_like(normal[..., 0])
    trial = torch.stack([torch.where(cond, zero, one), torch.where(cond, one, zero), zero], dim=-1)
    t = trial - torch.sum(trial * normal, dim=-1, keepdim=True) * normal
    n = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    return torch.where(n > 1e-15, t / torch.clamp(n, min=1e-15), trial)


def _group_circles(positions, topo):
    """(normal, center, radius, counts) of each fit or slide group, from the members' positions."""
    dtype = positions.dtype
    rows, group, valid = _x(topo, "m_rows"), _x(topo, "m_group"), _x(topo, "m_valid")
    g_count = _x(topo, "g_mode").shape[0]
    key = "constraint:pin_to_circle/group_sums"

    def sums(values, tag):
        return group_sums(values, topo, f"{key}/{tag}", group, valid, g_count)

    pts = positions[rows]
    first = sums(torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1), "1")
    counts = first[:, 3]
    n = torch.clamp(counts, min=1.0)
    centroid = first[:, :3] / n[:, None]

    # the PCA normal from the 3x3 scatter matrix unless one is given
    centered = pts - centroid[group]
    cov = sums((centered[:, :, None] * centered[:, None, :]).reshape(-1, 9), "9")
    cov = cov.reshape(g_count, 3, 3)
    fit_normal = torch.stack([dlinalg.smallest_eigvec_3x3(cov[g]) for g in range(g_count)])
    normal = torch.where(_x(topo, "g_has_normal")[:, None], _x(topo, "g_normal").to(dtype),
                         fit_normal)
    normal = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=1, keepdim=True),
                                  min=1e-15)

    # slide: center = base point + mean((p - base point) . n) n
    base_point = _x(topo, "g_point").to(dtype)
    offs = torch.sum((pts - base_point[group]) * normal[group], dim=1)
    # fit: the algebraic least-squares circle in the group plane through the
    # centroid, the normal equations of A = [2x, 2y, 1], b = x^2 + y^2
    u = _default_tangent(normal)
    v = torch.linalg.cross(normal, u)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-15)
    rel = pts - centroid[group]
    rel_in_plane = rel - torch.sum(rel * normal[group], dim=1, keepdim=True) * normal[group]
    x = torch.sum(rel_in_plane * u[group], dim=1)
    y = torch.sum(rel_in_plane * v[group], dim=1)
    b = x * x + y * y
    S = sums(torch.stack([4 * x * x, 4 * x * y, 4 * y * y, 2 * x, 2 * y, 2 * x * b, 2 * y * b,
                          b, offs], dim=1), "fit")
    Sxx, Sxy, Syy, Sx, Sy, Bx, By, B1, off_sum = S.unbind(1)
    A = torch.stack([torch.stack([Sxx, Sxy, Sx], dim=1), torch.stack([Sxy, Syy, Sy], dim=1),
                     torch.stack([Sx, Sy, counts], dim=1)], dim=1)
    A = A + 1e-18 * torch.eye(3, dtype=dtype, device=A.device)[None]
    # solve_ex: a singular system gives non-finite values, as the JAX
    # package's solve does, without a host read of the LU's status; under
    # ``torch.func.vmap`` each member's batch of groups is its own call (a
    # batched LU picks its routine by the batch count)
    sol = per_member(_solve_groups, A, torch.stack([Bx, By, B1], dim=1)[:, :, None])
    a_c, b_c, d_c = sol[:, :, 0].unbind(1)
    r_fit = torch.sqrt(torch.clamp(d_c + a_c**2 + b_c**2, min=1e-18))
    fit_center = centroid + a_c[:, None] * u + b_c[:, None] * v

    slide_center = base_point + (off_sum / n)[:, None] * normal
    # the slide radius: the members' mean in-plane distance from the slide center
    radial = rel_in_plane - (slide_center - centroid)[group]
    slide_r = sums(torch.linalg.vector_norm(radial, dim=1)[:, None], "r")[:, 0] / n

    is_slide = _x(topo, "g_mode") == MODE_SLIDE
    center = torch.where(is_slide[:, None], slide_center, fit_center)
    radius = torch.where(is_slide, slide_r, r_fit)
    radius = torch.where(_x(topo, "g_has_radius"), _x(topo, "g_radius").to(dtype), radius)
    return normal, center, radius, counts


def _solve_groups(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, b).result


def _project_rows(positions, rows, valid, normal, center, radius, preserve):
    """Project the ``valid`` entries onto their circles; ``preserve`` keeps their normal offset."""
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
    if preserve is not None:
        projected = torch.where(preserve[:, None], projected + off_n[:, None] * normal, projected)
    # invalid entries write into a scratch row, which is dropped
    nv = positions.shape[0]
    safe_rows = torch.where(valid, rows, nv)
    ext = torch.cat([positions, positions.new_zeros((1, 3))])
    ext = ext.index_put((safe_rows,), torch.where(valid[:, None], projected, 0.0))
    return ext[:nv]


def enforce(state, topo, params, context: str = "minimize"):
    positions = state.positions
    dtype = positions.dtype
    preserve_on = context in {"mesh_operation", "finalize"}
    positions = _project_rows(
        positions, _x(topo, "f_rows"), _x(topo, "f_valid"), _x(topo, "f_normal").to(dtype),
        _x(topo, "f_center").to(dtype), _x(topo, "f_radius").to(dtype),
        _x(topo, "f_preserve") if preserve_on else None)
    if _has_groups(topo):
        normal, center, radius, counts = _group_circles(positions, topo)
        group = _x(topo, "m_group")
        usable = _x(topo, "m_valid") & (counts[group] >= 3)  # a group of < 3 cannot fit
        positions = _project_rows(
            positions, _x(topo, "m_rows"), usable, normal[group], center[group], radius[group],
            _x(topo, "g_preserve")[group] if preserve_on else None)
    return dataclasses.replace(state, positions=positions)


def _pairs(positions, rows, valid, normal, center):
    """(rows, valid, plane normal, radial direction) per entry."""
    pts = positions[rows]
    pos_plane = pts - torch.sum((pts - center) * normal, dim=1, keepdim=True) * normal
    radial = pos_plane - center
    rnorm = torch.linalg.vector_norm(radial, dim=1)
    radial_hat = torch.where(
        rnorm[:, None] > 1e-15,
        radial / torch.clamp(rnorm, min=1e-15)[:, None],
        _default_tangent(normal),
    )
    return rows, valid, normal.expand_as(radial_hat), radial_hat


def _normal_pairs(positions, topo):
    """The fixed-mode entries' pairs, then the group members' (movable entries valid)."""
    dtype = positions.dtype
    out = [_pairs(positions, _x(topo, "f_rows"), _x(topo, "f_valid") & ~_x(topo, "f_vfixed"),
                  _x(topo, "f_normal").to(dtype), _x(topo, "f_center").to(dtype))]
    if _has_groups(topo):
        normal, center, _radius, _counts = _group_circles(positions, topo)
        group = _x(topo, "m_group")
        out.append(_pairs(positions, _x(topo, "m_rows"),
                          _x(topo, "m_valid") & ~_x(topo, "m_vfixed"), normal[group],
                          center[group]))
    return out


def constraint_gradient_rows(state, topo, params):
    """Two KKT rows (plane + radial) per movable pinned vertex: (2K, Nv, 3)."""
    positions = state.positions
    blocks = []
    for rows, valid, normal, radial_hat in _normal_pairs(positions, topo):
        k = rows.shape[0]
        out = positions.new_zeros((2 * k, positions.shape[0], 3))
        idx = torch.arange(k, device=rows.device)
        out = out.index_put((2 * idx, rows), torch.where(valid[:, None], normal, 0.0))
        blocks.append(out.index_put((2 * idx + 1, rows),
                                    torch.where(valid[:, None], radial_hat, 0.0)))
    return torch.cat(blocks) if len(blocks) > 1 else blocks[0]


def local_constraint_normals(state, topo, params):
    """(Nv, 2, 3) per-vertex normals (plane + radial).

    Duplicate entries of a vertex sum, in a fixed order (``vertex_sum.row_sum``):
    the fixed-mode entries, then the group members.
    """
    nv = state.positions.shape[0]
    parts = _normal_pairs(state.positions, topo)
    rows = torch.cat([p[0] for p in parts])
    valid = torch.cat([p[1] for p in parts])
    csr = kept_slot_csr(topo, "constraint:pin_to_circle/normals", rows, nv, keep=valid)
    return torch.stack([
        vertex_sum.row_sum(torch.where(valid[:, None], torch.cat([p[j] for p in parts]), 0.0),
                           csr)
        for j in (2, 3)
    ], dim=1)
