"""Mesh geometry over dense tensors.

Counterpart of ``membrane_solver_tpu/device/geo.py``: triangle normals and
areas, barycentric vertex areas, area-weighted vertex normals, cotan
curvature data (Meyer mixed-Voronoi areas with the obtuse branches),
interior angles and angle defects, body volumes, and the |K| norm whose
gradient falls back to the vertex normal at K = 0.  Arrays are
at exact size (no capacity padding); validity masks are kept and masked
rows contribute exactly zero.

:func:`surface_corner_terms` and :func:`curvature_corners` are the plain
twins of the CUDA kernels in ``kernels/tri_kernels``.  This module stays
plain PyTorch: the energy modules take the surface and curvature terms
from ``kernels/tri_kernels``, which launches the kernels for a CUDA tensor
and runs these twins for a CPU one.

Scatter-adds are ``index_add``: deterministic on the CPU, and on CUDA the
float atomics make the summation order vary from run to run.  The surface
energy, the cotan curvature data and the P1 divergence on the solver's
path go through ``kernels/tri_kernels`` instead, whose vertex sums run in
a fixed order on both devices.
"""

from __future__ import annotations

import dataclasses

import torch

EPS_AREA = 1e-12


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def safe_norm(vecs: torch.Tensor, eps: float = EPS_AREA) -> torch.Tensor:
    """Row norms with a zero (not NaN) gradient below ``eps``.

    The guard sits inside the sqrt (double ``where``): masking after the
    fact would still propagate the NaN of the untaken branch.
    """
    sq = torch.sum(vecs * vecs, dim=-1)
    good = sq > (eps * eps)
    return torch.where(good, torch.sqrt(torch.where(good, sq, torch.ones_like(sq))), 0.0)


@dataclasses.dataclass
class TriangleGeometry:
    """Per-evaluation shared geometry."""

    v0: torch.Tensor  # (F, 3) gathered corner positions
    v1: torch.Tensor
    v2: torch.Tensor
    normal: torch.Tensor  # (F, 3) unnormalized (doubled-area) normals
    double_area: torch.Tensor  # (F,)
    area: torch.Tensor  # (F,) masked triangle areas
    unit_normal: torch.Tensor  # (F, 3) zero on degenerate/invalid rows


def triangle_geometry(
    positions: torch.Tensor, tri_rows: torch.Tensor, tri_valid: torch.Tensor
) -> TriangleGeometry:
    v0 = positions[tri_rows[:, 0]]
    v1 = positions[tri_rows[:, 1]]
    v2 = positions[tri_rows[:, 2]]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    dbl = safe_norm(n)
    ok = tri_valid & (dbl >= EPS_AREA)
    unit = torch.where(ok[:, None], n / torch.clamp(dbl, min=EPS_AREA)[:, None], 0.0)
    area = torch.where(ok, 0.5 * dbl, 0.0)
    return TriangleGeometry(
        v0=v0, v1=v1, v2=v2, normal=n, double_area=dbl, area=area, unit_normal=unit
    )


def scatter_add_rows(
    values0: torch.Tensor,
    values1: torch.Tensor,
    values2: torch.Tensor,
    tri_rows: torch.Tensor,
    n_rows: int,
) -> torch.Tensor:
    """Scatter three per-triangle corner value arrays into per-vertex rows."""
    out = values0.new_zeros((n_rows,) + tuple(values0.shape[1:]))
    out = out.index_add(0, tri_rows[:, 0], values0)
    out = out.index_add(0, tri_rows[:, 1], values1)
    return out.index_add(0, tri_rows[:, 2], values2)


def barycentric_vertex_areas(geo: TriangleGeometry, tri_rows: torch.Tensor, n_rows: int):
    third = geo.area / 3.0
    return scatter_add_rows(third, third, third, tri_rows, n_rows)


def vertex_normals(
    geo: TriangleGeometry, tri_rows: torch.Tensor, tri_valid: torch.Tensor, n_rows: int
) -> torch.Tensor:
    """Area-weighted unit vertex normals (zero where the accumulation vanishes)."""
    n = torch.where(tri_valid[:, None], geo.normal, 0.0)
    acc = scatter_add_rows(n, n, n, tri_rows, n_rows)
    norms = safe_norm(acc, eps=1e-15)
    return torch.where(
        norms[:, None] > 1e-15, acc / torch.clamp(norms, min=1e-15)[:, None], 0.0
    )


def kink_threshold(dtype) -> float:
    """|K|-kink fallback threshold, above the dtype's cancellation noise.

    On a coplanar patch K is a sum of O(1) terms that cancel exactly,
    leaving |K| ~ eps(dtype) of noise with a random direction; below the
    threshold the direction falls back to the vertex normal.
    """
    return 1e-15 if dtype == torch.float64 else 1e-5


class _DirectionalNorm(torch.autograd.Function):
    """Row norms whose gradient direction falls back to ``fallback`` at |v| = 0.

    The JAX package defines this with ``custom_jvp``; its JVP ignores the
    fallback's tangent, so the fallback receives no gradient here either.
    """

    @staticmethod
    def forward(ctx, vecs, fallback):
        ctx.save_for_backward(vecs, fallback)
        return torch.linalg.vector_norm(vecs, dim=-1)

    @staticmethod
    def backward(ctx, grad_out):
        vecs, fallback = ctx.saved_tensors
        mag = torch.linalg.vector_norm(vecs, dim=-1)
        thresh = kink_threshold(vecs.dtype)
        use_dir = mag > thresh
        direction = torch.where(
            use_dir[..., None], vecs / torch.clamp(mag, min=thresh)[..., None], fallback
        )
        return grad_out[..., None] * direction, None


def directional_norm(vecs: torch.Tensor, fallback_dirs: torch.Tensor) -> torch.Tensor:
    """Row norms; the derivative at |vecs| = 0 follows ``fallback_dirs``."""
    return _DirectionalNorm.apply(vecs, fallback_dirs)


@dataclasses.dataclass
class CurvatureData:
    """Cotan-Laplacian data per Meyer et al. 2003."""

    k_vecs: torch.Tensor  # (V, 3) integrated mean-curvature vectors
    vertex_areas: torch.Tensor  # (V,) mixed-Voronoi areas
    weights: torch.Tensor  # (F, 3) per-corner cotangents
    corner_areas: torch.Tensor  # (F, 3) per-corner mixed-area contributions


def surface_corner_terms(v0, v1, v2, gamma):
    """Per-triangle surface energy and its corner gradients: (e, g0, g1, g2).

    ``e = gamma * A`` and ``g_k = dE/dv_k = gamma/2 * n_hat x (v_{k+2} -
    v_{k+1})``, zero where the doubled area is below ``EPS_AREA``.  Plain
    twin of the ``tri_surface_fwd`` CUDA kernel (``kernels/tri_kernels``),
    which replaces the JAX package's ``_surface_kernel``; the Pallas
    kernel's corner gradients are this function's with the opposite sign
    (its cross product takes the edge first).
    """
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    dbl = torch.sqrt(_dot(n, n))
    ok = dbl >= EPS_AREA
    n_hat = torch.where(ok[:, None], n / torch.clamp(dbl, min=EPS_AREA)[:, None], 0.0)
    area = torch.where(ok, 0.5 * dbl, 0.0)
    half_g = (0.5 * gamma)[:, None]
    g0 = half_g * torch.linalg.cross(n_hat, v2 - v1)
    g1 = half_g * torch.linalg.cross(n_hat, v0 - v2)
    g2 = half_g * torch.linalg.cross(n_hat, v1 - v0)
    return gamma * area, g0, g1, g2


def curvature_corners(v0, v1, v2, tri_valid):
    """Per-triangle cotan curvature terms: (cot, k0, k1, k2, va, tri_areas).

    Cotangent weights (T, 3), the corner mean-curvature vectors k0..k2
    (T, 3), the Meyer mixed-Voronoi corner areas va (T, 3) with the obtuse
    branches, all masked by ``tri_valid``, and the unmasked triangle areas
    (T,).  The per-triangle part of :func:`curvature_data` and the plain
    twin of the ``tri_curvature_fwd`` CUDA kernel (``kernels/tri_kernels``),
    which replaces the JAX package's ``_curvature_kernel``; its autograd is
    the twin of ``tri_curvature_bwd``.
    """
    e0 = v2 - v1
    e1 = v0 - v2
    e2 = v1 - v0

    l0_sq = _dot(e0, e0)
    l1_sq = _dot(e1, e1)
    l2_sq = _dot(e2, e2)

    dbl = torch.clamp(safe_norm(torch.linalg.cross(e1, e2)), min=EPS_AREA)
    c0 = _dot(-e1, e2) / dbl
    c1 = _dot(-e2, e0) / dbl
    c2 = _dot(-e0, e1) / dbl

    mask = tri_valid.to(v0.dtype)
    k0 = 0.5 * (c1[:, None] * (-e1) + c2[:, None] * e2) * mask[:, None]
    k1 = 0.5 * (c2[:, None] * (-e2) + c0[:, None] * e0) * mask[:, None]
    k2 = 0.5 * (c0[:, None] * (-e0) + c1[:, None] * e1) * mask[:, None]

    tri_areas = 0.5 * dbl
    obt0 = c0 < 0
    obt1 = c1 < 0
    obt2 = c2 < 0
    any_obt = obt0 | obt1 | obt2

    va0 = torch.where(~any_obt, (l1_sq * c1 + l2_sq * c2) / 8.0, 0.0)
    va1 = torch.where(~any_obt, (l2_sq * c2 + l0_sq * c0) / 8.0, 0.0)
    va2 = torch.where(~any_obt, (l0_sq * c0 + l1_sq * c1) / 8.0, 0.0)
    va0 = torch.where(obt0, tri_areas / 2.0, va0)
    va0 = torch.where(obt1 | obt2, tri_areas / 4.0, va0)
    va1 = torch.where(obt1, tri_areas / 2.0, va1)
    va1 = torch.where(obt0 | obt2, tri_areas / 4.0, va1)
    va2 = torch.where(obt2, tri_areas / 2.0, va2)
    va2 = torch.where(obt0 | obt1, tri_areas / 4.0, va2)
    va = torch.stack([va0 * mask, va1 * mask, va2 * mask], dim=1)
    cot = torch.stack([c0, c1, c2], dim=1) * mask[:, None]
    return cot, k0, k1, k2, va, tri_areas


def curvature_data(
    positions: torch.Tensor,
    tri_rows: torch.Tensor,
    tri_valid: torch.Tensor,
    n_rows: int,
) -> CurvatureData:
    """Cotan curvature data: :func:`curvature_corners` scattered to vertices."""
    corners = (positions[tri_rows[:, 0]], positions[tri_rows[:, 1]], positions[tri_rows[:, 2]])
    cot, k0, k1, k2, va, _tri_areas = curvature_corners(*corners, tri_valid)
    return CurvatureData(
        k_vecs=scatter_add_rows(k0, k1, k2, tri_rows, n_rows),
        vertex_areas=scatter_add_rows(va[:, 0], va[:, 1], va[:, 2], tri_rows, n_rows),
        weights=cot,
        corner_areas=va,
    )


def interior_angles(
    positions: torch.Tensor, tri_rows: torch.Tensor, tri_valid: torch.Tensor
) -> torch.Tensor:
    """Per-corner interior angles, shape (F, 3); zero on invalid rows."""
    v0 = positions[tri_rows[:, 0]]
    v1 = positions[tri_rows[:, 1]]
    v2 = positions[tri_rows[:, 2]]
    tiny = 1e-300 if positions.dtype == torch.float64 else 1e-30

    def corner_angle(p, a, b):
        u = a - p
        w = b - p
        nu = torch.linalg.vector_norm(u, dim=1)
        nw = torch.linalg.vector_norm(w, dim=1)
        cosang = _dot(u, w) / torch.clamp(nu * nw, min=tiny)
        return torch.arccos(torch.clamp(cosang, -1.0, 1.0))

    angles = torch.stack(
        [corner_angle(v0, v1, v2), corner_angle(v1, v2, v0), corner_angle(v2, v0, v1)], dim=1
    )
    return torch.where(tri_valid[:, None], angles, 0.0)


def angle_defects(
    positions: torch.Tensor,
    tri_rows: torch.Tensor,
    tri_valid: torch.Tensor,
    vertex_valid: torch.Tensor,
    boundary_vertex_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Integrated Gaussian curvature 2*pi - sum(angles); boundary rows zeroed."""
    ang = interior_angles(positions, tri_rows, tri_valid)
    angle_sum = scatter_add_rows(ang[:, 0], ang[:, 1], ang[:, 2], tri_rows, positions.shape[0])
    defects = torch.where(vertex_valid, 2.0 * torch.pi - angle_sum, 0.0)
    # vertices with no incident triangles contribute nothing
    defects = torch.where(angle_sum > 0, defects, 0.0)
    if boundary_vertex_mask is not None:
        defects = torch.where(boundary_vertex_mask, 0.0, defects)
    return defects


def body_volumes(
    positions: torch.Tensor,
    tri_rows: torch.Tensor,
    tri_valid: torch.Tensor,
    tri_body: torch.Tensor,
    n_bodies: int,
) -> torch.Tensor:
    """Divergence-theorem volumes per body slot: sum v0.(v1 x v2)/6 over facets.

    ``tri_body`` holds ``n_bodies`` (or more) for a facet of no body; those
    land in a spare row that is dropped, as the JAX package's segment sum
    over ``n_bodies + 1`` segments does.
    """
    v0 = positions[tri_rows[:, 0]]
    v1 = positions[tri_rows[:, 1]]
    v2 = positions[tri_rows[:, 2]]
    contrib = torch.where(tri_valid, _dot(torch.linalg.cross(v1, v2), v0) / 6.0, 0.0)
    out = contrib.new_zeros(n_bodies + 1)
    return out.index_add(0, torch.clamp(tri_body, 0, n_bodies), contrib)[:n_bodies]


def min_edge_length(
    positions: torch.Tensor, edge_rows: torch.Tensor, edge_valid: torch.Tensor
) -> torch.Tensor:
    vecs = positions[edge_rows[:, 1]] - positions[edge_rows[:, 0]]
    lengths = torch.linalg.vector_norm(vecs, dim=1)
    return torch.min(torch.where(edge_valid, lengths, torch.inf))


def project_to_tangent(field: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Remove the normal component of a per-vertex vector field."""
    return field - _dot(field, normals)[:, None] * normals


def check_normal_rotation(
    old_positions: torch.Tensor,
    new_positions: torch.Tensor,
    tri_rows: torch.Tensor,
    tri_valid: torch.Tensor,
    limit_radians: float = 0.5,
) -> torch.Tensor:
    """True when no valid triangle's normal rotates more than the limit."""

    def normals_of(p):
        a = p[tri_rows[:, 0]]
        b = p[tri_rows[:, 1]]
        c = p[tri_rows[:, 2]]
        n = torch.linalg.cross(b - a, c - a)
        return n, torch.linalg.vector_norm(n, dim=1)

    n_old, norm_old = normals_of(old_positions)
    n_new, norm_new = normals_of(new_positions)
    good_old = tri_valid & (norm_old > EPS_AREA)
    collapsed = good_old & (norm_new < EPS_AREA)
    tiny = 1e-300 if old_positions.dtype == torch.float64 else 1e-30
    cosang = _dot(n_old, n_new) / torch.clamp(norm_old * norm_new, min=tiny)
    angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    rotated_too_far = good_old & (angle > limit_radians)
    return ~(torch.any(collapsed) | torch.any(rotated_too_far))
