"""Rigid-body constraint on a disk patch.

Counterpart of ``membrane_solver_tpu/constraints/rigid_disk.py``:

- the disk vertices are those whose ``rigid_disk_group`` option equals the
  ``rigid_disk_group`` global parameter, or, without it, the ``preset:
  disk`` vertices;
- the reference shape is the first-seen disk geometry, kept on the host
  mesh (``mesh._rigid_disk_ref``, per group) across recompiles and taken
  anew only when the disk's vertex ids change (a refinement);
- KKT shape rows: the pairwise distances of an anchor triplet a -> all,
  b -> rest, c -> rest (+diff at i, -diff at j), fully fixed pairs skipped,
  in a dense and in a compact (K, 2, 3) form on (K, 2) rows; the KKT
  projector takes the compact one;
- ``make_enforce``: the disk moved onto the closest rigid transform of the
  reference (a Kabsch fit, ``device/linalg.rotation_from_cross_covariance``);
  with ``rigid_disk_radius`` (or the ``disk`` definition's
  ``pin_to_circle_radius``) the rim vertices (``preset`` or
  ``rim_slope_match_group`` equal to ``rigid_disk_rim_group``, default
  "rim") are re-pinned to that radius in the transformed disk plane and the
  fit is made a second time.  That branch is a static flag.

The disk rows, its rim rows and each pair's two rows are distinct, so the
writes are ``index_put`` of one value per row.  The fit's weighted means
and products add in ``device/reduce.tree_sum``'s order and term by term
(``device/linalg``), so under ``torch.func.vmap`` (the parameter sweep) a
member's fit is the bits of its own call's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.device import linalg as dlinalg
from membrane_solver_tpu_torch.device.reduce import tree_sum

_PREFIX = "constraint:rigid_disk"


def _collect_vids(mesh, group):
    vids = []
    for vid in sorted(mesh.vertices):
        opts = mesh.vertices[vid].options or {}
        if group is not None:
            if str(opts.get("rigid_disk_group") or "") == group:
                vids.append(vid)
        elif str(opts.get("preset") or "") == "disk":
            vids.append(vid)
    return vids


def _anchor_pairs(ref: np.ndarray):
    """Independent distance pairs from an anchor triplet (a -> all, b -> rest, c -> rest)."""
    n = ref.shape[0]
    if n < 2:
        return []
    a = 0
    d = np.linalg.norm(ref - ref[a], axis=1)
    b = int(np.argmax(d))
    c = None
    if n >= 3:
        ab = ref[b] - ref[a]
        ab_n = ab / max(np.linalg.norm(ab), 1e-15)
        perp = ref - ref[a] - np.outer((ref - ref[a]) @ ab_n, ab_n)
        c = int(np.argmax(np.linalg.norm(perp, axis=1)))
        if c in (a, b):
            c = None
    pairs, seen = [], set()

    def add(i, j):
        if i == j:
            return
        key = (i, j) if i < j else (j, i)
        if key not in seen:
            seen.add(key)
            pairs.append(key)

    for i in range(n):
        if i != a:
            add(a, i)
    for i in range(n):
        if i not in {a, b}:
            add(b, i)
    if c is not None:
        for i in range(n):
            if i not in {a, b, c}:
                add(c, i)
    return pairs


def _radius(mesh):
    """``rigid_disk_radius``, else the ``disk`` definition's ``pin_to_circle_radius``, else None."""
    radius = mesh.global_parameters.get("rigid_disk_radius")
    if radius is None:
        defs = getattr(mesh, "definitions", {}) or {}
        disk_def = defs.get("disk") if isinstance(defs.get("disk"), dict) else None
        if disk_def:
            radius = disk_def.get("pin_to_circle_radius")
    return radius


def compile_topology(layout) -> dict:
    mesh = layout.mesh
    gp = mesh.global_parameters
    raw_group = gp.get("rigid_disk_group")
    group = str(raw_group).strip() if raw_group is not None else None
    vids = _collect_vids(mesh, group)
    if len(vids) < 2:
        return {
            "rows": np.zeros(1, dtype=np.int64),
            "valid": np.zeros(1, dtype=bool),
            "ref": np.zeros((1, 3)),
            "pairs": np.zeros((1, 2), dtype=np.int64),
            "pairs_valid": np.zeros(1, dtype=bool),
            "rim_local": np.zeros(1, dtype=np.int64),
            "rim_valid": np.zeros(1, dtype=bool),
            "target_radius": np.asarray(0.0),
            "has_radius": np.asarray(False),
        }

    # the first-seen reference shape, kept across recompiles
    cache = getattr(mesh, "_rigid_disk_ref", None)
    if cache is None:
        cache = {}
        setattr(mesh, "_rigid_disk_ref", cache)
    key = group or "<preset:disk>"
    entry = cache.get(key)
    if entry is None or entry["vids"] != vids:
        ref = np.array([mesh.vertices[v].position for v in vids], dtype=float)
        cache[key] = {"vids": list(vids), "ref": ref.copy()}
    ref = cache[key]["ref"]

    rim_group = str(gp.get("rigid_disk_rim_group") or "rim").strip() or "rim"
    rim_local = [
        i
        for i, v in enumerate(vids)
        if str((mesh.vertices[v].options or {}).get("preset") or "") == rim_group
        or str((mesh.vertices[v].options or {}).get("rim_slope_match_group") or "") == rim_group
    ]
    radius = _radius(mesh)
    pairs = _anchor_pairs(ref)
    return {
        "rows": np.asarray([layout.row_of[int(v)] for v in vids], dtype=np.int64),
        "valid": np.ones(len(vids), dtype=bool),
        "ref": ref.copy(),
        "pairs": np.asarray(pairs or [(0, 0)], dtype=np.int64).reshape(-1, 2),
        "pairs_valid": np.ones(len(pairs), dtype=bool) if pairs else np.zeros(1, dtype=bool),
        "rim_local": np.asarray(rim_local or [0], dtype=np.int64),
        "rim_valid": np.ones(len(rim_local), dtype=bool) if rim_local else np.zeros(1, dtype=bool),
        "target_radius": np.asarray(float(radius or 0.0)),
        "has_radius": np.asarray(radius is not None),
    }


def compile_static(layout):
    """("has_radius", bool): whether the fit re-pins the rim and fits again (a static branch)."""
    return ("has_radius", _radius(layout.mesh) is not None)


def _pair_slot_rows(state, topo):
    """(gi, gj, ri, rj): each pair's rows and gradients (+diff at i, -diff at j), fixed rows zero."""
    x = lambda k: topo.extras[f"{_PREFIX}/{k}"]  # noqa: E731
    rows = x("rows")
    pairs = x("pairs")
    pvalid = x("pairs_valid")
    positions = state.positions
    ri = rows[pairs[:, 0]]
    rj = rows[pairs[:, 1]]
    fixed_i = topo.fixed_mask[ri]
    fixed_j = topo.fixed_mask[rj]
    use = pvalid & ~(fixed_i & fixed_j)
    diff = positions[ri] - positions[rj]
    gi = torch.where((use & ~fixed_i)[:, None], diff, 0.0)
    gj = torch.where((use & ~fixed_j)[:, None], -diff, 0.0)
    return gi, gj, ri, rj


def make_constraint_gradient_rows(spec):
    """Dense (K, Nv, 3) pairwise-distance rows (the compact form is what the projector takes)."""

    def fn(state, topo, params):
        if f"{_PREFIX}/rows" not in topo.extras:
            return None
        positions = state.positions
        gi, gj, ri, rj = _pair_slot_rows(state, topo)
        k = ri.shape[0]
        idx = torch.arange(k, device=positions.device)
        out = positions.new_zeros((k, positions.shape[0], 3))
        return out.index_put((idx, ri), gi).index_put((idx, rj), gj)  # ri != rj per pair

    return fn


def make_compact_constraint_rows(spec):
    """Compact pairwise rows: (values (K, 2, 3), rows (K, 2)), the dense rows' nonzero slots.

    The rows are fixed per topology (a fully fixed pair carries zero
    values), so the KKT projector keeps their slot CSR.
    """

    def fn(state, topo, params):
        if f"{_PREFIX}/rows" not in topo.extras:
            return None
        gi, gj, ri, rj = _pair_slot_rows(state, topo)
        return torch.stack([gi, gj], dim=1), torch.stack([ri, rj], dim=1)

    return fn


def make_enforce(spec):
    has_radius = bool(spec.static_of(_PREFIX, ("has_radius", False))[1])

    def enforce(state, topo, params, context="minimize"):
        if f"{_PREFIX}/rows" not in topo.extras:
            return state
        x = lambda k: topo.extras[f"{_PREFIX}/{k}"]  # noqa: E731
        rows = x("rows")
        valid = x("valid")
        dtype = state.positions.dtype
        tiny = dlinalg._tiny(dtype)
        ref = x("ref").to(dtype)
        w = valid.to(dtype)[:, None]
        n_live = torch.clamp(tree_sum(w), min=1.0)

        def wmean(a):
            return tree_sum(a * w, dim=0) / n_live

        def fit(target):
            """(R, t) of the masked Kabsch fit of the reference onto ``target``."""
            Qc = wmean(target)
            R = dlinalg.rotation_from_cross_covariance(
                dlinalg.cross_gram_3x3(P0, (target - Qc) * w), tiny)
            return R, Qc - dlinalg.mv3(R, Pc)

        Pc = wmean(ref)
        P0 = (ref - Pc) * w
        R, t = fit(state.positions[rows])
        corrected = dlinalg.mm3(ref, R.T) + t

        if has_radius:
            rim_local = x("rim_local")
            target_r = x("target_radius").to(dtype)
            rel = (ref - Pc) * w
            normal_ref = dlinalg.smallest_eigvec_3x3(dlinalg.gram_3x3(rel))
            center = dlinalg.mv3(R, Pc) + t
            normal = dlinalg.mv3(R, normal_ref)
            normal = normal / torch.clamp(torch.linalg.vector_norm(normal), min=1e-12)
            p = corrected[rim_local]
            v = p - center
            v_plane = v - torch.sum(v * normal, dim=1, keepdim=True) * normal
            nrm = torch.linalg.vector_norm(v_plane, dim=1)
            ok = x("rim_valid") & (nrm > 1e-12)
            pinned = center + target_r * v_plane / torch.clamp(nrm, min=1e-12)[:, None]
            corrected = corrected.index_put((rim_local,), torch.where(ok[:, None], pinned, p))
            # the second fit, onto the rim-pinned targets
            R, t = fit(corrected)
            corrected = dlinalg.mm3(ref, R.T) + t

        return dataclasses.replace(state, positions=state.positions.index_put((rows,), corrected))

    return enforce
