"""Mesh geometry over dense tensors.

Counterpart of ``membrane_solver_tpu/device/geo.py``: triangle normals and
areas, barycentric vertex areas, area-weighted vertex normals, cotan
curvature data (Meyer mixed-Voronoi areas with the obtuse branches),
interior angles and angle defects, body volumes, and the |K| norm whose
gradient falls back to the vertex normal at K = 0.  Arrays are
at exact size (no capacity padding); validity masks are kept and masked
rows contribute exactly zero.

:func:`surface_corner_terms` and :func:`curvature_corners` are the plain
twins of the CUDA kernels in ``kernels/tri_kernels``: the energy modules
take the surface and curvature terms from ``kernels/tri_kernels``, which
launches the kernels for a CUDA tensor and runs these twins for a CPU one.

Every sum runs in a fixed order, so two runs give the same bits on the
card too: the corner-to-vertex sums (:func:`scatter_add_rows`) go through
the vertex-sum kernel in the order of the topology's corner CSR
(``kernels/vertex_sum.vertex_sum``; its plain twin on the CPU), which is
the JAX package's scatter order, and the per-body sums (:func:`body_sums`)
are masked reductions on the card, one row per body, in place of the JAX
package's segment sums.
"""

from __future__ import annotations

import dataclasses

import torch

from membrane_solver_tpu_torch.device.state import CornerCSR
from membrane_solver_tpu_torch.kernels import vertex_sum as vs

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
    csr: CornerCSR,
) -> torch.Tensor:
    """Sum three per-triangle corner value arrays (T,) or (T, 3) into vertex rows.

    ``csr`` is the topology's corner CSR (``Topology.corner_csr()``): the
    rows are added in its order, by the vertex-sum kernel on the card and
    its twin on the CPU, and the backward gathers.
    """
    return vs.vertex_sum(torch.stack([values0, values1, values2], dim=1), csr)


def body_sums(values: torch.Tensor, tri_body: torch.Tensor, n_bodies: int) -> torch.Tensor:
    """Per-triangle values (T,) summed per body slot: (n_bodies,).

    Triangles whose ``tri_body`` is ``n_bodies`` or more (no body) are
    dropped, as the JAX package's spare segment is.  On the card,
    :func:`masked_body_sums` (no atomics); on the CPU, ``index_add``, which
    adds in triangle order there, as the JAX package's segment sum does.
    The masked reduction differs from that order at round-off, and the CG
    stepper on the symmetric cube amplifies round-off past the CPU parity
    tests' bars (``tests/test_torch_steppers.py``,
    ``test_stepper_history_survives_between_calls[cg-10]``), so the CPU keeps
    the segment sum's bits.
    """
    if values.is_cuda:
        return masked_body_sums(values, tri_body, n_bodies)
    out = values.new_zeros(n_bodies + 1)
    return out.index_add(0, torch.clamp(tri_body, 0, n_bodies), values)[:n_bodies]


def masked_body_sums(values: torch.Tensor, tri_body: torch.Tensor, n_bodies: int) -> torch.Tensor:
    """:func:`body_sums` as a masked (n_bodies, T) reduction, on any device.

    A PyTorch reduction adds in a fixed order for a fixed shape, so two
    calls give the same bits; ``n_bodies`` is small and static.
    """
    slots = torch.arange(n_bodies, device=tri_body.device)[:, None]
    return torch.sum(torch.where(tri_body[None, :] == slots, values[None, :], 0.0), dim=1)


def barycentric_vertex_areas(geo: TriangleGeometry, csr: CornerCSR):
    third = geo.area / 3.0
    return scatter_add_rows(third, third, third, csr)


def vertex_normals(geo: TriangleGeometry, tri_valid: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    """Area-weighted unit vertex normals (zero where the accumulation vanishes)."""
    n = torch.where(tri_valid[:, None], geo.normal, 0.0)
    acc = scatter_add_rows(n, n, n, csr)
    norms = safe_norm(acc, eps=1e-15)
    return torch.where(
        norms[:, None] > 1e-15, acc / torch.clamp(norms, min=1e-15)[:, None], 0.0
    )


def p1_shape_gradients(geo: TriangleGeometry) -> torch.Tensor:
    """P1 per-triangle shape gradients, shape (F, 3 corners, 3 xyz).

    g_i = (n x e_i) / |n|^2 with e_i the edge opposite corner i
    (e_0 = v2 - v1, e_1 = v0 - v2, e_2 = v1 - v0).  The plain form for the
    connection_v1 transport; the ambient paths take g from
    ``tri_kernels.p1_triangle_divergence``.
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

    generate_vmap_rule = True  # plain operations: the sweep maps it over its members

    @staticmethod
    def forward(vecs, fallback):
        return torch.linalg.vector_norm(vecs, dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

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
    csr: CornerCSR,
) -> CurvatureData:
    """Cotan curvature data: :func:`curvature_corners` summed into vertex rows over ``csr``."""
    corners = (positions[tri_rows[:, 0]], positions[tri_rows[:, 1]], positions[tri_rows[:, 2]])
    cot, k0, k1, k2, va, _tri_areas = curvature_corners(*corners, tri_valid)
    return CurvatureData(
        k_vecs=scatter_add_rows(k0, k1, k2, csr),
        vertex_areas=scatter_add_rows(va[:, 0], va[:, 1], va[:, 2], csr),
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
    csr: CornerCSR,
    boundary_vertex_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Integrated Gaussian curvature 2*pi - sum(angles); boundary rows zeroed."""
    ang = interior_angles(positions, tri_rows, tri_valid)
    angle_sum = scatter_add_rows(ang[:, 0], ang[:, 1], ang[:, 2], csr)
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
    are dropped (:func:`body_sums`), as the JAX package's segment sum over
    ``n_bodies + 1`` segments drops its spare one.
    """
    v0 = positions[tri_rows[:, 0]]
    v1 = positions[tri_rows[:, 1]]
    v2 = positions[tri_rows[:, 2]]
    contrib = torch.where(tri_valid, _dot(torch.linalg.cross(v1, v2), v0) / 6.0, 0.0)
    return body_sums(contrib, tri_body, n_bodies)


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
