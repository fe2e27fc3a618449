"""Mesh geometry over dense tensors.

Counterpart of ``membrane_solver_tpu/device/geo.py``: triangle normals and
areas, barycentric vertex areas, area-weighted vertex normals, P1 shape
gradients, cotan curvature data (Meyer mixed-Voronoi areas with the obtuse
branches), and the |K| norm whose gradient falls back to the vertex normal
at K = 0.  Arrays are at exact size (no capacity padding); validity masks
are kept and masked rows contribute exactly zero.

Scatter-adds are ``index_add``: deterministic on the CPU, and on CUDA the
float atomics make the summation order vary from run to run.
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


def p1_shape_gradients(geo: TriangleGeometry) -> torch.Tensor:
    """P1 per-triangle shape gradients, shape (F, 3 corners, 3 xyz).

    g_i = (n x e_i) / |n|^2 with e_i the edge opposite corner i
    (e_0 = v2 - v1, e_1 = v0 - v2, e_2 = v1 - v0).
    """
    e0 = geo.v2 - geo.v1
    e1 = geo.v0 - geo.v2
    e2 = geo.v1 - geo.v0
    inv_n2 = 1.0 / torch.clamp(geo.double_area**2, min=EPS_AREA**2)
    g0 = torch.linalg.cross(geo.normal, e0) * inv_n2[:, None]
    g1 = torch.linalg.cross(geo.normal, e1) * inv_n2[:, None]
    g2 = torch.linalg.cross(geo.normal, e2) * inv_n2[:, None]
    return torch.stack([g0, g1, g2], dim=1)


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


def curvature_data(
    positions: torch.Tensor,
    tri_rows: torch.Tensor,
    tri_valid: torch.Tensor,
    n_rows: int,
) -> CurvatureData:
    v0 = positions[tri_rows[:, 0]]
    v1 = positions[tri_rows[:, 1]]
    v2 = positions[tri_rows[:, 2]]
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

    mask = tri_valid.to(positions.dtype)
    k0 = 0.5 * (c1[:, None] * (-e1) + c2[:, None] * e2) * mask[:, None]
    k1 = 0.5 * (c2[:, None] * (-e2) + c0[:, None] * e0) * mask[:, None]
    k2 = 0.5 * (c0[:, None] * (-e0) + c1[:, None] * e1) * mask[:, None]
    k_vecs = scatter_add_rows(k0, k1, k2, tri_rows, n_rows)

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
    va0 = va0 * mask
    va1 = va1 * mask
    va2 = va2 * mask
    vertex_areas = scatter_add_rows(va0, va1, va2, tri_rows, n_rows)

    weights = torch.stack([c0, c1, c2], dim=1) * mask[:, None]
    corner_areas = torch.stack([va0, va1, va2], dim=1)
    return CurvatureData(
        k_vecs=k_vecs, vertex_areas=vertex_areas, weights=weights, corner_areas=corner_areas
    )


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
