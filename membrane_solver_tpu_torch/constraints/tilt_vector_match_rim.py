"""Hard per-leaflet in-plane tilt matching between disk and rim rings.

Counterpart of ``membrane_solver_tpu/constraints/tilt_vector_match_rim.py``:
the vertices tagged (``tilt_vector_match_group``, ``tilt_vector_match_role``
disk or rim) pair per group by polar angle in the group's frame (center:
the mean of both rings; normal: the disk ring's plane fit).  Only groups
whose rings have equal counts pair; the others are skipped, as in the JAX
package.  Per group and per basis vector (u, v), one aggregated KKT row per
leaflet: +dvec at the rim rows, -dvec at the disk rows.  ``make_enforce_tilts``
sets each pair's in-plane components to the mode's target
(``tilt_vector_match_mode``: average, rim_to_disk or disk_to_rim, with the
aliases rim2disk and disk2rim), a fixed side keeping its own.  Pairing and
bases are fixed when the problem is compiled.  A vertex lies in one group
and role, so every write is one value per row.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from membrane_solver_tpu_torch.constraints.local_interface_shells import layout_positions
from membrane_solver_tpu_torch.device.state import check_unique_rows

_PREFIX = "constraint:tilt_vector_match_rim"


def _usable_group_count(mesh) -> int:
    """Groups with equal nonzero disk and rim counts (the pairable ones)."""
    counts = defaultdict(lambda: {"disk": 0, "rim": 0})
    for vid in mesh.vertices:
        opts = mesh.vertices[vid].options or {}
        group = opts.get("tilt_vector_match_group")
        role = str(opts.get("tilt_vector_match_role") or "").strip().lower()
        if group is not None and role in {"disk", "rim"}:
            counts[str(group)][role] += 1
    return sum(1 for c in counts.values() if c["disk"] and c["disk"] == c["rim"])


def compile_static(layout):
    gp = layout.mesh.global_parameters
    mode = str(gp.get("tilt_vector_match_mode") or "average").strip().lower()
    if mode in {"rim_to_disk", "rim2disk"}:
        mode = "rim_to_disk"
    elif mode in {"disk_to_rim", "disk2rim"}:
        mode = "disk_to_rim"
    else:
        mode = "average"
    return (mode, _usable_group_count(layout.mesh))


def _in_plane_basis(normal):
    trial = np.array([1.0, 0, 0]) if abs(normal[0]) <= 0.9 else np.array([0, 1.0, 0])
    u = trial - float(trial @ normal) * normal
    u /= max(np.linalg.norm(u), 1e-15)
    return u, np.cross(normal, u)


def _order_by_angle(pos, center, normal):
    rel = pos - center
    rel = rel - np.outer(rel @ normal, normal)
    u, v = _in_plane_basis(normal)
    return np.argsort(np.arctan2(rel @ v, rel @ u))


def compile_topology(layout) -> dict:
    mesh = layout.mesh
    grouped = defaultdict(lambda: {"disk": [], "rim": []})
    for vid in sorted(mesh.vertices):
        opts = mesh.vertices[vid].options or {}
        group = opts.get("tilt_vector_match_group")
        role = str(opts.get("tilt_vector_match_role") or "").strip().lower()
        if group is None or role not in {"disk", "rim"}:
            continue
        grouped[str(group)][role].append(layout.row_of[int(vid)])

    pos = layout_positions(layout)
    pairs_rim, pairs_disk, gids, us, vs = [], [], [], [], []
    for group in sorted(grouped):
        disk = np.asarray(grouped[group]["disk"], dtype=int)
        rim = np.asarray(grouped[group]["rim"], dtype=int)
        if disk.size == 0 or rim.size == 0 or disk.size != rim.size:
            continue
        disk_pos, rim_pos = pos[disk], pos[rim]
        center = np.mean(np.vstack([disk_pos, rim_pos]), axis=0)
        _, _, vh = np.linalg.svd(disk_pos - disk_pos.mean(axis=0), full_matrices=False)
        normal = vh[-1]
        disk = disk[_order_by_angle(disk_pos, center, normal)]
        rim = rim[_order_by_angle(rim_pos, center, normal)]
        u, v = _in_plane_basis(normal)
        pairs_rim.extend(rim.tolist())
        pairs_disk.extend(disk.tolist())
        gids.extend([len(us)] * rim.size)
        us.append(u)
        vs.append(v / max(np.linalg.norm(v), 1e-15))

    if not pairs_rim:
        return {
            "rim": np.zeros(1, dtype=np.int64),
            "disk": np.zeros(1, dtype=np.int64),
            "gid": np.zeros(1, dtype=np.int64),
            "valid": np.zeros(1, dtype=bool),
            "u": np.zeros((1, 3)),
            "v": np.zeros((1, 3)),
            "n_groups": np.asarray(0),
        }
    check_unique_rows(pairs_rim + pairs_disk, "tilt_vector_match_rim rings")
    return {
        "rim": np.asarray(pairs_rim, dtype=np.int64),
        "disk": np.asarray(pairs_disk, dtype=np.int64),
        "gid": np.asarray(gids, dtype=np.int64),
        "valid": np.ones(len(pairs_rim), dtype=bool),
        "u": np.asarray(us),
        "v": np.asarray(vs),
        "n_groups": np.asarray(len(us)),
    }


def make_tilt_constraint_rows(spec):
    n_groups = spec.static_of(_PREFIX, ("average", 0))[1]

    def fn(state, topo, params):
        if f"{_PREFIX}/rim" not in topo.extras or n_groups == 0:
            return None
        x = lambda k: topo.extras[f"{_PREFIX}/{k}"]  # noqa: E731
        rim = x("rim")
        disk = x("disk")
        gidx = x("gid")
        valid = x("valid")
        dtype = state.positions.dtype
        zeros = state.positions.new_zeros((state.positions.shape[0], 3))
        rows = []
        for g in range(n_groups):
            in_group = (valid & (gidx == g))[:, None]
            for key in ("u", "v"):
                dvec = x(key)[g].to(dtype)
                grad = zeros.index_put((rim,), torch.where(in_group, dvec, 0.0)).index_put(
                    (disk,), torch.where(in_group, -dvec, 0.0))
                rows.append(torch.stack([grad, zeros], dim=0))  # in-leaflet row
                rows.append(torch.stack([zeros, grad], dim=0))  # out-leaflet row
        return torch.stack(rows, dim=0)

    return fn


def make_enforce_tilts(spec):
    mode, n_groups = spec.static_of(_PREFIX, ("average", 0))[:2]

    def enforce(state, topo, params):
        if f"{_PREFIX}/rim" not in topo.extras or n_groups == 0:
            return state
        x = lambda k: topo.extras[f"{_PREFIX}/{k}"]  # noqa: E731
        rim = x("rim")
        disk = x("disk")
        gidx = x("gid")
        valid = x("valid")
        dtype = state.positions.dtype
        u = x("u").to(dtype)[gidx]  # (k, 3) per-pair basis
        v = x("v").to(dtype)[gidx]

        def project(tilts, fixed_mask):
            d_fix = fixed_mask[disk]
            r_fix = fixed_mask[rim]
            cd = torch.stack([torch.sum(tilts[disk] * u, dim=1), torch.sum(tilts[disk] * v, dim=1)],
                             dim=1)
            cr = torch.stack([torch.sum(tilts[rim] * u, dim=1), torch.sum(tilts[rim] * v, dim=1)],
                             dim=1)
            if mode == "rim_to_disk":
                target = cr
            elif mode == "disk_to_rim":
                target = cd
            else:
                target = 0.5 * (cd + cr)
                target = torch.where(d_fix[:, None], cd, target)
                target = torch.where(r_fix[:, None], cr, target)
            both = d_fix & r_fix
            ok_d = valid & ~d_fix & ~both
            ok_r = valid & ~r_fix & ~both
            dd = (target[:, 0] - cd[:, 0])[:, None] * u + (target[:, 1] - cd[:, 1])[:, None] * v
            dr = (target[:, 0] - cr[:, 0])[:, None] * u + (target[:, 1] - cr[:, 1])[:, None] * v
            tilts = tilts.index_add(0, disk, torch.where(ok_d[:, None], dd, 0.0))
            return tilts.index_add(0, rim, torch.where(ok_r[:, None], dr, 0.0))

        tin = project(state.tilts_in, topo.tilt_fixed_in_mask)
        tout = project(state.tilts_out, topo.tilt_fixed_out_mask)
        return dataclasses.replace(state, tilts_in=tin, tilts_out=tout)

    return enforce
