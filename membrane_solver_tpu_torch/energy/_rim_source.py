"""Shared core of the caveolin rim source work terms (in / out / bilayer).

Counterpart of ``membrane_solver_tpu/energy/_rim_source.py``:

    E = - sum_edges gamma_e * L_e * (t_avg_e . r_hat_e)

over the rim edges whose endpoints carry ``pin_to_circle_group == group``
(``tilt_rim_source_edge_mode`` ``boundary``, the default, keeps only edges
with fewer than two facets; ``all`` keeps every tagged edge).  t_avg is the
edge-midpoint average of the module's tilt field (t_in, t_out, or t_in +
t_out for the bilayer term); r_hat the in-plane radial direction of the
midpoint about the rim circle's frame: the fixed (center parameter, option
or z normal) pair, or, when the rim's ``pin_to_circle_mode`` is ``fit``,
the live centroid of the rim rows and the option normal or the fitted
plane normal (``device/linalg.smallest_eigvec_3x3``).  A work term: tilt
gradients only, positions detached.  The per-edge strengths resolve on the
host when the problem is compiled (``contact_mapping``); the tables hold
the live edges and rim rows only, and every sum is a reduction over them.
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.device import linalg as dlinalg
from membrane_solver_tpu_torch.device.reduce import tree_sum
from membrane_solver_tpu_torch.energy.contact_mapping import resolve_contact_line_strength


def _tag_group(options) -> str | None:
    if not options:
        return None
    group = options.get("pin_to_circle_group")
    return "default" if group is None else str(group)


def build_compile_topology(prefix: str, group_key: str, strength_key: str, suffix: str):
    """The compile_topology hook of one rim-source module."""

    def compile_topology(layout) -> dict:
        mesh = layout.mesh
        gp = mesh.global_parameters
        empty = {
            "tails": np.zeros(1, dtype=np.int64),
            "heads": np.zeros(1, dtype=np.int64),
            "valid": np.zeros(1, dtype=bool),
            "gamma": np.zeros(1),
            "rim_rows": np.zeros(1, dtype=np.int64),
            "rim_valid": np.zeros(1, dtype=bool),
            "follow": np.asarray(False),
            "center": np.zeros(3),
            "normal": np.array([0.0, 0.0, 1.0]),
            "has_normal": np.asarray(False),
        }
        raw_group = gp.get(group_key)
        if raw_group is None or not str(raw_group).strip():
            return empty
        group = str(raw_group).strip()
        mode = str(gp.get("tilt_rim_source_edge_mode") or "boundary").strip().lower()

        edges = []
        for eid, edge in mesh.edges.items():
            v0 = mesh.vertices[edge.tail_index]
            v1 = mesh.vertices[edge.head_index]
            if _tag_group(v0.options) != group or _tag_group(v1.options) != group:
                continue
            if mode != "all" and len(mesh.facets_of_edge(int(eid))) >= 2:
                continue
            edges.append(edge)
        if not edges:
            return empty

        gamma = [
            resolve_contact_line_strength(gp, getattr(e, "options", None),
                                          strength_key=strength_key, contact_suffix=suffix).gamma
            for e in edges
        ]
        rim_rows = sorted(
            {layout.row_of[int(vid)] for vid, v in mesh.vertices.items()
             if _tag_group(v.options) == group}
        )
        first = mesh.vertices[int(layout.vertex_ids[rim_rows[0]])]
        follow = str((first.options or {}).get("pin_to_circle_mode") or "fixed").lower() == "fit"
        raw_normal = (first.options or {}).get("pin_to_circle_normal")
        if raw_normal is not None:
            normal = np.asarray(raw_normal, dtype=float).reshape(3)
            normal /= max(np.linalg.norm(normal), 1e-15)
            has_normal = True
        else:
            normal = np.array([0.0, 0.0, 1.0])
            has_normal = False
        return {
            "tails": np.asarray([layout.row_of[e.tail_index] for e in edges], dtype=np.int64),
            "heads": np.asarray([layout.row_of[e.head_index] for e in edges], dtype=np.int64),
            "valid": np.ones(len(edges), dtype=bool),
            "gamma": np.asarray(gamma, dtype=float),
            "rim_rows": np.asarray(rim_rows, dtype=np.int64),
            "rim_valid": np.ones(len(rim_rows), dtype=bool),
            "follow": np.asarray(follow),
            "center": np.asarray(gp.get("tilt_rim_source_center") or [0.0, 0.0, 0.0],
                                 dtype=float),
            "normal": normal,
            "has_normal": np.asarray(has_normal),
        }

    return compile_topology


def rim_source_energy(state, topo, params, *, prefix: str, strength_key: str, fields):
    """E = -sum gamma L (t_avg . r_hat); ``fields`` names the tilt arrays summed."""
    positions = state.positions.detach()
    dtype = positions.dtype
    if f"energy:{prefix}/tails" not in topo.extras:
        return positions.new_zeros(())
    x = lambda k: topo.extras[f"energy:{prefix}/{k}"]  # noqa: E731
    valid = x("valid")
    tails = x("tails")
    heads = x("heads")
    gamma = params.get(strength_key)
    gamma_e = torch.where(valid, x("gamma").to(dtype) if gamma is None else gamma, 0.0)

    p0 = positions[tails]
    p1 = positions[heads]
    mid = 0.5 * (p0 + p1)
    lengths = torch.linalg.vector_norm(p1 - p0, dim=1)

    # the followed frame is selected on the device (no host read of the flags)
    rim_valid = x("rim_valid")
    pts = positions[x("rim_rows")]
    w = rim_valid.to(dtype)[:, None]
    centroid = tree_sum(pts * w, dim=0) / torch.clamp(tree_sum(w), min=1.0)
    rel = (pts - centroid) * w
    fit_normal = dlinalg.smallest_eigvec_3x3(dlinalg.gram_3x3(rel))
    follow = x("follow")
    center = torch.where(follow, centroid, x("center").to(dtype))
    normal = torch.where(follow & ~x("has_normal"), fit_normal, x("normal").to(dtype))

    r = mid - center
    r = r - torch.sum(r * normal, dim=1, keepdim=True) * normal
    rn = torch.linalg.vector_norm(r, dim=1)
    good = valid & (rn > 1e-12)
    r_hat = torch.where(good[:, None], r / torch.clamp(rn, min=1e-12)[:, None], 0.0)

    t_avg = torch.zeros_like(mid)
    for field in fields:
        arr = getattr(state, field)
        t_avg = t_avg + 0.5 * (arr[tails] + arr[heads])
    dots = torch.sum(t_avg * r_hat, dim=1)
    return -tree_sum(torch.where(good, gamma_e * lengths * dots, 0.0))
