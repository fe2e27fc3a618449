"""Automatic mesh-quality repair via bounded equiangulation passes.

Counterpart of ``membrane_solver_tpu/runtime/quality.py``: the same NumPy
host code, reading the compiled problem's tensors through ``.cpu().numpy()``.

Parity: reference ``runtime/mesh_quality_repair.py`` — every
``mesh_quality_auto_repair_every`` minimize iterations, if the p90 triangle
aspect ratio (h_max/h_min) exceeds ``mesh_quality_aspect_threshold``, run up
to ``mesh_quality_max_repair_passes`` equiangulation passes, re-enforce hard
constraints, and reset the stepper.
"""

from __future__ import annotations

import numpy as np

from membrane_solver_tpu_torch.runtime.equiangulation import equiangulate_iteration


def triangle_aspect_percentile(minimizer, percentile: float = 90.0) -> float:
    p = minimizer.problem()
    tri_rows = p.topo.tri_rows.cpu().numpy()[: p.n_tris]
    if tri_rows.shape[0] == 0:
        return float("nan")
    pos = p.state.positions.detach().cpu().numpy()
    tri = pos[tri_rows]
    e01 = np.linalg.norm(tri[:, 0] - tri[:, 1], axis=1)
    e12 = np.linalg.norm(tri[:, 1] - tri[:, 2], axis=1)
    e20 = np.linalg.norm(tri[:, 2] - tri[:, 0], axis=1)
    h_max = np.maximum.reduce([e01, e12, e20])
    h_min = np.minimum.reduce([e01, e12, e20])
    return float(np.percentile(h_max / np.maximum(h_min, 1e-18), float(percentile)))


def maybe_auto_mesh_quality_repair(minimizer) -> bool:
    gp = minimizer.global_params
    if not bool(gp.get("mesh_quality_auto_repair_enabled", False)):
        return False
    threshold = float(gp.get("mesh_quality_aspect_threshold", 0.0) or 0.0)
    if threshold <= 0.0:
        return False
    perc = float(gp.get("mesh_quality_aspect_percentile", 90.0) or 90.0)
    max_passes = int(gp.get("mesh_quality_max_repair_passes", 1) or 1)
    if max_passes <= 0:
        return False

    aspect = triangle_aspect_percentile(minimizer, perc)
    if not np.isfinite(aspect) or aspect <= threshold:
        return False

    changed_any = False
    minimizer._sync_host()
    for _ in range(max_passes):
        new_mesh, changed = equiangulate_iteration(minimizer.mesh)
        if not changed:
            break
        minimizer.set_mesh(new_mesh)
        minimizer.enforce_constraints_after_mesh_ops(new_mesh)
        minimizer.mesh.project_tilts_to_tangent()
        changed_any = True
        aspect = triangle_aspect_percentile(minimizer, perc)
        if not np.isfinite(aspect) or aspect <= threshold:
            break
    return changed_any
