"""Leaflet bending-tilt coupling core: E = 1/2 sum kappa (2H - c0 + s*div t)^2 dA.

Counterpart of ``membrane_solver_tpu/energy/bending_tilt_leaflet.py`` in its
default modes (update mode ``off``, divergence ``p1_triangle``, current
geometry base term).  The energy value and tilt gradient use the per-corner
form

    base_term_v = 2 H_v - c0_v           (zeroed on boundary rows)
    div_tri     = div_sign * P1 divergence of the leaflet tilt field
    E = 0.5 * sum_tri sum_corner kappa (base_corner + div_tri)^2 va_eff_corner

while the shape gradient is that of the vertex-averaged surrogate with the
divergence frozen.  Both come from one expression: the corner form at
detached positions, plus a surrogate whose coefficients are detached and
whose value cancels against its own detached copy.  The ``.detach()`` calls
sit where the JAX package has ``stop_gradient``.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.energy import param
from membrane_solver_tpu_torch.kernels import tri_kernels

USES_TILT_LEAFLETS = True


def _redistributed_va(corner_areas, topo, keep):
    """Boundary-redistributed mixed-Voronoi corner areas, keep-masked."""
    va = corner_areas
    tri_is_b = topo.boundary_vertex_mask[topo.tri_rows]
    interior_c = ~tri_is_b
    n_int = torch.sum(interior_c, dim=1)
    redistribute = (n_int > 0) & torch.any(tri_is_b, dim=1)
    b_sum = torch.sum(torch.where(tri_is_b, va, 0.0), dim=1)
    extra = torch.where(redistribute, b_sum / torch.clamp(n_int, min=1), 0.0)
    va_eff = torch.where(
        redistribute[:, None], torch.where(interior_c, va + extra[:, None], 0.0), va
    )
    return torch.where(keep[:, None], va_eff, 0.0)


def _fields(positions, topo, params, kappa_key, c0_key, tri_present=None):
    """Full-value leaflet fields: (base, va_eff, a_eff, kappa, interior, extra)."""
    keep = topo.tri_valid if tri_present is None else (topo.tri_valid & tri_present)
    geo = dgeo.triangle_geometry(positions, topo.tri_rows, keep)
    vnormals = dgeo.vertex_normals(geo, keep, topo.corner_csr())
    curv = tri_kernels.curvature_data(positions, topo.tri_rows, topo.tri_valid, topo.corner_csr())
    safe_vor = torch.clamp(curv.vertex_areas, min=1e-12)
    H = dgeo.directional_norm(curv.k_vecs, vnormals) / (2.0 * safe_vor)

    kappa = param(params, kappa_key, "bending_modulus", like=positions)
    c0 = param(
        params, c0_key, "spontaneous_curvature", "intrinsic_curvature", like=positions
    )
    interior = topo.vertex_valid & ~topo.boundary_vertex_mask
    base_term = torch.where(interior, 2.0 * H - c0, 0.0)

    va_eff = _redistributed_va(curv.corner_areas, topo, keep)
    a_eff = dgeo.scatter_add_rows(va_eff[:, 0], va_eff[:, 1], va_eff[:, 2], topo.corner_csr())
    extra = {
        "H": H,
        "safe_vor": safe_vor,
        "k_vecs": curv.k_vecs,
        "vnormals": vnormals,
        "keep": keep,
    }
    return base_term, va_eff, a_eff, kappa, interior, extra


def leaflet_bending_tilt_energy(
    state, topo, params, *, tilts, kappa_key: str, div_sign: float, c0_key: str,
    tri_present=None,
):
    positions = state.positions
    # Every field of the corner form and every surrogate coefficient is
    # detached in the JAX package (stop_gradient of the positions or of the
    # coefficient itself), so the fields are computed once, without a graph.
    with torch.no_grad():
        base, va_eff, a_eff, kappa, interior, xf = _fields(
            positions, topo, params, kappa_key, c0_key, tri_present
        )

    # --- corner form at frozen positions: value + exact tilt gradient -----
    div_tri, _, _ = tri_kernels.p1_triangle_divergence(
        positions.detach(), tilts, topo.tri_rows, topo.tri_valid, topo.corner_csr()
    )
    div_term = div_sign * div_tri
    base_c = base[topo.tri_rows]
    keep = xf["keep"]
    term_c = base_c + div_term[:, None]
    sqs = term_c**2
    corner = 0.5 * torch.sum(torch.where(keep, kappa * torch.sum(sqs * va_eff, dim=1), 0.0))

    # --- vertex-form surrogate: shape gradient with frozen divergence ------
    with torch.no_grad():
        div_eff_num = dgeo.scatter_add_rows(
            va_eff[:, 0] * div_term,
            va_eff[:, 1] * div_term,
            va_eff[:, 2] * div_term,
            topo.corner_csr(),
        )
        div_eff = torch.where(
            a_eff > 1e-20, div_eff_num / torch.clamp(a_eff, min=1e-20), 0.0
        )
        term_v = torch.where(interior & topo.vertex_valid, base + div_eff, 0.0)
        ratio = torch.where(xf["safe_vor"] > 1e-15, a_eff / xf["safe_vor"], 0.0)
        k_mag = torch.linalg.vector_norm(xf["k_vecs"], dim=1)
        k_thresh = dgeo.kink_threshold(k_mag.dtype)
        k_dir = torch.where(
            (k_mag > k_thresh)[:, None],
            xf["k_vecs"] / torch.clamp(k_mag, min=k_thresh)[:, None],
            xf["vnormals"],
        )
        coef_K = (kappa * term_v * ratio)[:, None] * k_dir
        coef_a_eff = 0.5 * kappa * term_v**2
        coef_a_vor = -2.0 * kappa * term_v * ratio * xf["H"]

    curv_k = tri_kernels.curvature_data(positions, topo.tri_rows, keep, topo.corner_csr())
    va_k = _redistributed_va(curv_k.corner_areas, topo, keep)
    a_eff_k = dgeo.scatter_add_rows(va_k[:, 0], va_k[:, 1], va_k[:, 2], topo.corner_csr())
    surrogate = (
        torch.sum(coef_K * curv_k.k_vecs)
        + torch.sum(coef_a_eff * a_eff_k)
        + torch.sum(coef_a_vor * curv_k.vertex_areas)
    )
    return corner + surrogate - surrogate.detach()


def check_default_modes(layout, leaflet: str) -> None:
    """Raise when the mesh selects a bending-tilt mode the port does not run."""
    gp = layout.mesh.global_parameters
    for key in (
        f"bending_tilt_assume_J0_presets_{leaflet}",
        "bending_tilt_assume_J0_presets",
    ):
        if gp.get(key) is not None:
            raise NotImplementedError(f"{key} is not ported to membrane_solver_tpu_torch")
    mode = str(gp.get("bending_tilt_base_term_region_mode") or "off").strip().lower()
    if mode != "off":
        raise NotImplementedError(
            f"bending_tilt_base_term_region_mode={mode!r} is not ported to "
            "membrane_solver_tpu_torch"
        )


def make_leaflet_bending_tilt_frozen(
    spec, *, leaflet: str, kappa_key: str, div_sign: float, c0_key: str
):
    """Frozen split for the inner tilt solve (positions constant).

    The surrogate contributes zero value and zero tilt gradient, so the
    per-iteration energy is the corner form alone, with the base term, the
    effective corner areas and the P1 shape gradients baked once per relax
    call.  The shape gradients come from the ``p1_div`` kernel (one launch
    per relax; its divergence of the current tilts goes unused).
    """

    def precompute(state, topo, params):
        from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles

        positions = state.positions
        tri_present = present_triangles(topo, leaflet)
        base_f, va_eff_f, _a, _k, _i, xf = _fields(
            positions, topo, params, kappa_key, c0_key, tri_present
        )
        tilts = state.tilts_in if leaflet == "in" else state.tilts_out
        _div, _area, g = tri_kernels.p1_triangle_divergence(
            positions.detach(), tilts.detach(), topo.tri_rows, topo.tri_valid, topo.corner_csr()
        )
        return {
            "base_c": base_f[topo.tri_rows],
            "va_eff": va_eff_f,
            "g": g,
            "keep": xf["keep"],
        }

    def energy(tin, tout, fr, topo, params, ctx=None):
        kappa = param(params, kappa_key, "bending_modulus", like=tin)
        g = fr["g"]
        if ctx is not None:
            corners = ctx["tin_c"] if leaflet == "in" else ctx["tout_c"]
            t0, t1, t2 = corners[:, 0], corners[:, 1], corners[:, 2]
        else:
            tilts = tin if leaflet == "in" else tout
            t0 = tilts[topo.tri_rows[:, 0]]
            t1 = tilts[topo.tri_rows[:, 1]]
            t2 = tilts[topo.tri_rows[:, 2]]
        div = (
            torch.sum(t0 * g[:, 0], dim=1)
            + torch.sum(t1 * g[:, 1], dim=1)
            + torch.sum(t2 * g[:, 2], dim=1)
        )
        div = torch.where(topo.tri_valid, div, 0.0)
        div = div_sign * div
        term_c = fr["base_c"] + div[:, None]
        sqs = term_c**2
        return 0.5 * torch.sum(
            torch.where(fr["keep"], kappa * torch.sum(sqs * fr["va_eff"], dim=1), 0.0)
        )

    return precompute, energy


def assume_J0_center_xy(gp):
    """xy center for radial clipping: ``tilt_thetaB_center``, else ``pin_to_circle_point``, else 0.

    The JAX package's helper of the same name (its inner-coupled delta cap
    and assume-J0 radius clip read it); a copy, so the port imports nothing
    of the JAX package.
    """
    import numpy as np

    raw = gp.get("tilt_thetaB_center")
    if raw is None:
        raw = gp.get("pin_to_circle_point")
    if raw is None:
        return np.zeros(2)
    arr = np.asarray(raw, dtype=float).reshape(-1)
    return arr[:2] if arr.size >= 2 else np.zeros(2)
