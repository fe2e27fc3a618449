"""Hard per-facet area constraint (damped Lagrange steps with clamped moves).

Counterpart of ``membrane_solver_tpu/constraints/fix_facet_area.py``:
facets with a ``target_area`` option are projected toward it by the step
``x -= lam * grad(A)``, lam halved until no vertex moves more than 0.1x the
facet's diameter and the area error strictly decreases (12 backtracking
trials, 5 outer iterations, tol 1e-12); fixed vertices never move; the
facets are processed one after the other (they share vertices).  The
JAX package's fixed-trip loops with masked updates become Python loops
over the same trip counts with the same masked updates: no host read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TOL = 1e-12
MAX_OUTER = 5
MAX_BACKTRACK = 12


def _entries(layout):
    out = []
    for fid, slot in layout.tri_slot_of.items():
        t = layout.mesh.facets[fid].options.get("target_area")
        if t is not None:
            out.append((slot, float(t)))
    return out


def compile_static(layout):
    """The number of constrained facets: the unrolled loop's length."""
    return len(_entries(layout))


def compile_topology(layout) -> dict:
    entries = _entries(layout)
    k = max(len(entries), 1)
    slot_arr = np.zeros(k, dtype=np.int64)
    target_arr = np.zeros(k)
    valid = np.zeros(k, dtype=bool)
    for i, (s, t) in enumerate(entries):
        slot_arr[i], target_arr[i], valid[i] = s, t, True
    return {"slots": slot_arr, "target": target_arr, "valid": valid}


def _facet_area_grad(pos, rows):
    """Area and per-corner gradients (3, 3) of one triangle (rows: (3,))."""
    v0, v1, v2 = pos[rows[0]], pos[rows[1]], pos[rows[2]]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    dbl = torch.sqrt(torch.clamp(torch.sum(n * n), min=1e-30))
    n_hat = n / dbl
    g = torch.stack([
        0.5 * torch.linalg.cross(v1 - v2, n_hat),
        0.5 * torch.linalg.cross(v2 - v0, n_hat),
        0.5 * torch.linalg.cross(v0 - v1, n_hat),
    ])
    return 0.5 * dbl, g


def _project_facet(positions, rows, target, active, movable):
    pts = positions[rows]
    diameter = torch.max(torch.linalg.vector_norm(pts[:, None, :] - pts[None, :, :], dim=2))
    max_move = torch.where(diameter > 0, 0.1 * diameter, 1e-3)
    stop = ~active
    for _ in range(MAX_OUTER):
        area, g = _facet_area_grad(positions, rows)
        delta = area - target
        norm_sq = torch.sum(g * g)
        lam = delta / (norm_sq + 1e-18)
        done = stop | (torch.abs(delta) < TOL) | (norm_sq < 1e-18)
        applied, success = positions, torch.zeros_like(stop)
        for _ in range(MAX_BACKTRACK):
            disp = -lam * g * movable
            too_far = torch.max(torch.linalg.vector_norm(disp, dim=1)) > max_move
            # the triangle's three rows are distinct: a plain put adds once per row
            trial = positions.index_put((rows,), positions[rows] + torch.where(success, 0.0, disp))
            new_area, _ = _facet_area_grad(trial, rows)
            better = torch.abs(new_area - target) < torch.abs(delta)
            accept = (~success) & (~too_far) & better
            lam = torch.where(accept | success, lam, lam * 0.5)
            applied = torch.where(accept, trial, applied)
            success = success | accept
        positions = torch.where(done | ~active, positions, torch.where(success, applied, positions))
        stop = done | ~success
    return positions


def make_enforce(spec):
    k = spec.static_of("constraint:fix_facet_area", 0)
    if not k:
        return None

    def enforce(state, topo, params, context: str = "minimize"):
        x = lambda key: topo.extras[f"constraint:fix_facet_area/{key}"]  # noqa: E731
        slots, targets, valid = x("slots"), x("target"), x("valid")
        positions = state.positions
        for i in range(k):
            rows = topo.tri_rows[slots[i]]
            movable = (~topo.fixed_mask[rows]).to(positions.dtype)[:, None]
            positions = _project_facet(positions, rows, targets[i],
                                       valid[i] & topo.tri_valid[slots[i]], movable)
        return dataclasses.replace(state, positions=positions)

    return enforce
