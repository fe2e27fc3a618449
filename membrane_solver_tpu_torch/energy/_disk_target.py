"""Shared core of the soft disk tilt-profile targets (in / out leaflets).

Counterpart of ``membrane_solver_tpu/energy/_disk_target.py``:

    E = 1/2 k integral |t - theta(r) r_hat|^2 dA       (diff zeroed off-disk)
    theta(r) = theta_B * I1(lam r) / I1(lam R)         (lam -> 0: theta_B r / R)

assembled per triangle as 0.5 k (sum_corner |diff|^2 / 3) A_tri over the
vertices tagged ``tilt_disk_target_group<sfx>``.  lam comes from
``tilt_disk_target_lambda<sfx>`` or sqrt(k_tilt / kappa) (with the
reference's misspelled ``tilt_modolus<sfx>`` fallback); R is the explicit
radius or the largest in-plane radius of the ring.  The targets and diff
are built on detached positions and only the triangle areas stay live, so
the shape gradient is the JAX package's (the areas' gradient).  The ring
tables, the frame and the Bessel-series parameters are resolved on the
host when the problem is compiled; the normal's choice (given or fitted)
is a compile-time flag (``compile_static``), so the energy reads nothing
back from the device.
"""

from __future__ import annotations

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device import linalg as dlinalg


def _bessel_i1_series(x, n_terms: int = 30):
    t = 0.5 * x
    t2 = t * t
    term = t
    out = term
    for k in range(1, int(n_terms)):
        term = term * t2 / (k * (k + 1))
        out = out + term
    return out


def _getter(gp, sfx: str):
    def get(base):
        v = gp.get(f"{base}{sfx}")
        return gp.get(base) if v is None else v

    return get


def build_compile_topology(prefix: str, sfx: str):
    def compile_topology(layout) -> dict:
        mesh = layout.mesh
        gp = mesh.global_parameters
        get = _getter(gp, sfx)
        empty = {
            "rows": np.zeros(1, dtype=np.int64),
            "valid": np.zeros(1, dtype=bool),
            "center": np.zeros(3),
            "normal": np.array([0.0, 0.0, 1.0]),
            "has_normal": np.asarray(False),
            "radius": np.asarray(0.0),
            "has_radius": np.asarray(False),
            "lam": np.asarray(0.0),
            "theta_b": np.asarray(0.0),
        }
        raw_group = gp.get(f"tilt_disk_target_group{sfx}")
        if raw_group is None or not str(raw_group).strip():
            return empty
        group = str(raw_group).strip()
        # vertices tagged with the per-leaflet option key only
        rows = [
            layout.row_of[int(vid)]
            for vid in sorted(mesh.vertices)
            if (mesh.vertices[vid].options or {}).get(f"tilt_disk_target_group{sfx}") == group
        ]
        if not rows:
            return empty

        center = np.asarray(get("tilt_disk_target_center") or [0, 0, 0], dtype=float)
        raw_n = get("tilt_disk_target_normal")
        if raw_n is not None:
            normal = np.asarray(raw_n, dtype=float).reshape(3)
            normal /= max(np.linalg.norm(normal), 1e-15)
            has_normal = True
        else:
            normal = np.array([0.0, 0.0, 1.0])
            has_normal = False
        radius = get("tilt_disk_target_radius")
        lam = get("tilt_disk_target_lambda")
        if lam is None:
            k_tilt = gp.get(f"tilt_modulus{sfx}")
            if k_tilt is None:
                k_tilt = gp.get(f"tilt_modolus{sfx}")  # the reference's typo fallback
            kappa = gp.get(f"bending_modulus{sfx}") or gp.get("bending_modulus")
            try:
                lam = (
                    float(np.sqrt(float(k_tilt) / float(kappa)))
                    if k_tilt and kappa and float(k_tilt) > 0 and float(kappa) > 0
                    else 0.0
                )
            except (TypeError, ValueError):
                lam = 0.0
        theta_b = get("tilt_disk_target_theta_B") or 0.0
        return {
            "rows": np.asarray(rows, dtype=np.int64),
            "valid": np.ones(len(rows), dtype=bool),
            "center": center,
            "normal": normal,
            "has_normal": np.asarray(has_normal),
            "radius": np.asarray(float(radius or 0.0)),
            "has_radius": np.asarray(radius is not None),
            "lam": np.asarray(float(lam or 0.0)),
            "theta_b": np.asarray(float(theta_b)),
        }

    return compile_topology


def build_compile_static(prefix: str, sfx: str):
    """The compile-time flags (has_normal,), resolved as the topology hook resolves them."""

    def compile_static(layout):
        return (_getter(layout.mesh.global_parameters, sfx)("tilt_disk_target_normal")
                is not None,)

    return compile_static


def disk_target_energy(state, topo, params, *, prefix: str, sfx: str, field: str,
                       has_normal: bool):
    positions = state.positions
    dtype = positions.dtype
    if f"energy:{prefix}/rows" not in topo.extras:
        return positions.new_zeros(())
    x = lambda k: topo.extras[f"energy:{prefix}/{k}"]  # noqa: E731
    rows = x("rows")
    valid = x("valid")
    k_target = params.get(f"tilt_disk_target_strength{sfx}", positions.new_zeros(()))
    theta_b = x("theta_b").to(dtype)

    frozen = positions.detach()
    n_rows = frozen.shape[0]
    center = x("center").to(dtype)
    pts = frozen[rows]
    if has_normal:
        normal = x("normal").to(dtype)
    else:
        w = valid.to(dtype)[:, None]
        centroid = torch.sum(pts * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
        rel = (pts - centroid) * w
        normal = dlinalg.smallest_eigvec_3x3(rel.T @ rel)

    r_vec = pts - center
    r_vec = r_vec - torch.sum(r_vec * normal, dim=1, keepdim=True) * normal
    r_len = torch.linalg.vector_norm(r_vec, dim=1)
    good = valid & (r_len > 1e-12)
    r_hat = torch.where(good[:, None], r_vec / torch.clamp(r_len, min=1e-12)[:, None], 0.0)

    radius = torch.where(x("has_radius"), x("radius").to(dtype),
                         torch.max(torch.where(good, r_len, 0.0)))
    lam = x("lam").to(dtype)
    tiny = 1e-300 if dtype == torch.float64 else 1e-30
    theta_linear = theta_b * r_len / torch.clamp(radius, min=tiny)
    den = _bessel_i1_series(lam * radius)
    theta_bessel = theta_b * _bessel_i1_series(lam * r_len) / torch.where(
        torch.abs(den) < 1e-15, 1.0, den)
    theta = torch.where(torch.abs(lam) < 1e-12, theta_linear, theta_bessel)
    theta = torch.where(torch.abs(den) < 1e-15, 0.0, theta)

    # padding entries (an empty ring's one invalid row) go to a spare row
    safe_rows = torch.where(valid, rows, n_rows)
    target = frozen.new_zeros((n_rows + 1, 3))
    target[safe_rows] = torch.where(good[:, None], theta[:, None] * r_hat, 0.0)
    on_disk = torch.zeros(n_rows + 1, dtype=torch.bool, device=frozen.device)
    on_disk[safe_rows] = valid
    tilts = getattr(state, field)
    diff = torch.where(on_disk[:n_rows, None], tilts - target[:n_rows], 0.0)
    diff_sq = torch.sum(diff * diff, dim=1)

    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    tri_sum = sum(diff_sq[r] for r in topo.tri_rows.unbind(1))
    coeff = 0.5 * k_target * tri_sum / 3.0
    return torch.sum(torch.where(topo.tri_valid, coeff * geo.area, 0.0))
