"""Minimization core: energy assembly, KKT projection, Armijo line search.

Eager counterpart of ``membrane_solver_tpu/runtime/jit_core.py``.  The JAX
package traces each function below under ``jax.jit`` and runs the outer
iteration as a fixed-shape ``lax.while_loop``; here the same steps run
eagerly, the loops are Python loops, and each loop decision reads a device
scalar.  Gradients come from autograd through the energy assembly.

Ported branches: the gradient-descent, conjugate-gradient and BFGS
steppers, fixed and adaptive step sizes, the leaflet tilt relax (nested or
coupled) under its energy-spike guard, the single-field tilt relax, the
line search in its sequential and its batched form
(``utils/tuning.batched_line_search``) with its reduced-energy form (every
trial, and the baseline, re-relax the leaflet tilts; ``armijo`` or
``decrease_only`` acceptance; batched through the member-batched relax,
:data:`REDUCED_LS_FORM`),
the volume constraint's enforcement and post-step drift check, the
curved-theta ablation's module scales, the reference-exact rim KKT skip and
the shared-rim lanes' height-only shape descent.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.reduce import member_sum, per_member, tree_sum
from membrane_solver_tpu_torch.device.state import (
    MeshState,
    ProblemSpec,
    Topology,
    kept_slot_csr,
    slot_csr,
)
from membrane_solver_tpu_torch.energy import get_module
from membrane_solver_tpu_torch.kernels import vertex_sum
from membrane_solver_tpu_torch.utils.tuning import batched_line_search

# Armijo line-search constants (as in the JAX package)
LS_MAX_ITER = 10
LS_BETA = 0.7
LS_C = 1e-4
LS_GAMMA = 1.5
LS_ALPHA_MAX_FACTOR = 10.0
LS_ALPHA_FLOOR = 1e-8
SAFE_STEP_FRACTION = 0.3
NORMAL_LIMIT_RADIANS = 0.5
# the form the reduced-energy line search takes on each device
REDUCED_LS_FORM = ("batched on the card, sequential on the CPU (utils/tuning): candidate 0 alone, "
                   "then candidates 1-9 in one member pass whose trials relax the leaflet tilts "
                   "together (tilt_relax.make_relax_leaflet_tilts_members)")


def _np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


# ----------------------------------------------------------------------
# energy assembly
# ----------------------------------------------------------------------
def active_energy_modules(spec: ProblemSpec) -> Tuple[str, ...]:
    """Module names that can contribute (the volume penalty only in penalty mode)."""
    return tuple(
        name for name in spec.energy_modules
        if not (name == "volume" and spec.volume_mode != "penalty")
    )


_INNER_SCALED = frozenset({"tilt_in", "bending_tilt_in", "tilt_splay_twist_in", "tilt_smoothness_in"})
_OUTER_SCALED = frozenset({"tilt_out", "bending_tilt_out", "tilt_smoothness_out",
                           "tilt_rim_source_out", "tilt_disk_target_out"})


def module_scale_fn(spec: ProblemSpec, name: str):
    """The curved-theta ablation's scale of module ``name``: scale(params, like) -> 0-dim, or None.

    Active only with ``curved_theta_objective_ablation_mode``
    ``inner_outer_rescaled`` on a ``benchmark_geometry_lane`` ``free_z``
    lane with ``benchmark_parameterization`` ``kh_physical``: the inner,
    outer and contact module families scale by the three
    ``curved_theta_objective_ablation_*_scale`` parameters (default 1).  Any
    other mode raises the JAX package's ValueError.
    """
    mode = spec.option("curved_theta_objective_ablation_mode", "off").lower()
    if mode == "off":
        return None
    if mode != "inner_outer_rescaled":
        raise ValueError(
            "curved_theta_objective_ablation_mode must be 'off' or "
            "'inner_outer_rescaled'."
        )
    if spec.option("benchmark_geometry_lane", "flat_pinned").lower() != "free_z":
        return None
    if spec.option("benchmark_parameterization", "legacy").lower() != "kh_physical":
        return None
    if name in _INNER_SCALED:
        key = "curved_theta_objective_ablation_inner_scale"
    elif name in _OUTER_SCALED:
        key = "curved_theta_objective_ablation_outer_scale"
    elif name == "tilt_thetaB_contact_in":
        key = "curved_theta_objective_ablation_contact_scale"
    else:
        return None

    def scale(params, like):
        value = params.get(key)
        return like.new_ones(()) if value is None else value

    return scale


def scaled(fn, sc):
    """``fn`` with its term multiplied by the ablation scale ``sc`` (``fn`` itself when None)."""
    if sc is None:
        return fn

    def term(geo, state, topo, params):
        e = fn(geo, state, topo, params)
        return sc(params, e) * e

    return term


def _energy_fns(spec: ProblemSpec):
    out = []
    for name in active_energy_modules(spec):
        module = get_module(name)
        maker = getattr(module, "make_energy", None)
        fn = maker(spec) if maker is not None else module.energy
        out.append((name, scaled(fn, module_scale_fn(spec, name))))
    return out


def make_total_energy(spec: ProblemSpec) -> Callable:
    """Return total_energy(state, topo, params) -> scalar."""
    fns = [fn for _name, fn in _energy_fns(spec)]

    def total_energy(state: MeshState, topo: Topology, params: Dict) -> torch.Tensor:
        geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
        e = state.positions.new_zeros(())
        for fn in fns:
            e = e + fn(geo, state, topo, params)
        return e

    return total_energy


def make_energy_value(spec: ProblemSpec) -> Callable:
    """Total-energy evaluation without a graph."""
    total = make_total_energy(spec)

    def value(state, topo, params):
        with torch.no_grad():
            return total(state, topo, params)

    return value


def make_energy_breakdown(spec: ProblemSpec) -> Callable:
    """fn(state, topo, params) -> {module name: energy}."""
    fns = _energy_fns(spec)

    def breakdown(state: MeshState, topo: Topology, params: Dict):
        with torch.no_grad():
            geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
            return {name: fn(geo, state, topo, params) for name, fn in fns}

    return breakdown


def make_energy_of_positions(spec: ProblemSpec) -> Callable:
    """Return energy_fn(positions, state, topo, params) with tilts held fixed."""
    total = make_total_energy(spec)

    def energy_fn(positions, state, topo, params):
        return total(dataclasses.replace(state, positions=positions), topo, params)

    return energy_fn


def make_energy_vg(spec: ProblemSpec) -> Callable:
    """vg(positions, state, topo, params) -> (E, dE/dpositions)."""
    energy_fn = make_energy_of_positions(spec)

    def vg(positions, state, topo, params):
        x = positions.detach().requires_grad_(True)
        with torch.enable_grad():
            E = energy_fn(x, state, topo, params)
            (g,) = torch.autograd.grad(E, (x,))
        return E.detach(), g

    return vg


def make_energy_and_grad(spec: ProblemSpec) -> Callable:
    """fn(state, topo, params) -> (E, projected shape gradient), as the block assembles them.

    The KKT projection sees the full gradient.  With ``rim_slope_match_mode``
    ``shared_rim_staggered_v1`` (the curved free-disk lanes), the projected
    gradient then keeps only its heights, and none on the outer ring's
    transition rows (``core:curved_disk/transition_mask``), so a constraint
    row with lateral parts cannot bring x/y descent back.  Fixed rows are
    zeroed last.
    """
    energy_vg = make_energy_vg(spec)
    finish = make_gradient_finisher(spec)

    def energy_and_grad(state, topo, params):
        E, g = energy_vg(state.positions, state, topo, params)
        return E, finish(g, state, topo, params)

    return energy_and_grad


def make_gradient_finisher(spec: ProblemSpec) -> Callable:
    """finish(g, state, topo, params) -> the block's shape gradient from the energy's gradient.

    The KKT projection, then the curved free-disk lanes' height-only
    restriction, then the fixed rows zeroed (:func:`make_energy_and_grad`).
    """
    gradient_projector = make_gradient_projector(spec)
    curved_disk = spec.option("rim_slope_match_mode", "").lower() == "shared_rim_staggered_v1"

    def finish(g, state, topo, params):
        if gradient_projector is not None:
            g = gradient_projector(g, state, topo, params)
        trans = topo.extras.get("core:curved_disk/transition_mask")
        if curved_disk and trans is not None:
            zero = torch.zeros_like(g[:, 0])
            g = torch.stack([zero, zero, torch.where(trans, 0.0, g[:, 2])], dim=1)
        return torch.where(topo.fixed_mask[:, None], 0.0, g)

    return finish


# ----------------------------------------------------------------------
# constraint KKT projection of the shape gradient
# ----------------------------------------------------------------------
def make_constraint_gradients(spec: ProblemSpec) -> Callable:
    """Return fn(state, topo, params) -> (k, Nv, 3) stacked dense constraint rows."""
    from membrane_solver_tpu_torch.constraints import get_constraint

    builders = []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        maker = getattr(mod, "make_constraint_gradient_rows", None)
        fn = maker(spec) if maker is not None else getattr(mod, "constraint_gradient_rows", None)
        if fn is not None:
            builders.append(fn)

    def all_gradients(state, topo, params):
        rows = [r for r in (fn(state, topo, params) for fn in builders) if r is not None]
        return torch.cat(rows) if rows else None

    return all_gradients


# A multiplier vector from the LU solve whose residual exceeds this share of
# max|b| (at least 1e4 machine epsilons) is taken for round-off in a null
# space (see solve_kkt_with_rescue).
KKT_RESIDUAL_RTOL = 1e-8
# the shift, as a share of max|diag(A)| (at least 100 machine epsilons), of
# the fallback's factorization, and its refinement passes toward the
# 1e-18-regularized system
KKT_SHIFT = 1e-10
KKT_REFINE_PASSES = 3
# When a list, each shape KKT solve appends (finite, refined, max|lam|) as
# device tensors: whether the LU multipliers were finite (the JAX package's
# branch), whether the fallback replaced them, and their size.  None (the
# default) records nothing.
KKT_RECORD = None


def _solve_with_rescue(A: torch.Tensor, b: torch.Tensor):
    """(multipliers, LU finite, fallback taken) of one system: :func:`solve_kkt_with_rescue`."""
    lu, piv, _info = torch.linalg.lu_factor_ex(A)
    lam = torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]
    finite = torch.all(torch.isfinite(lam))
    lam = torch.where(finite, lam, torch.zeros_like(lam))
    eps = torch.finfo(A.dtype).eps
    b_max = torch.max(torch.abs(b))
    residual = torch.max(torch.abs(A @ lam - b))
    refined = finite & (residual > max(KKT_RESIDUAL_RTOL, 1e4 * eps) * b_max)
    shift = max(KKT_SHIFT, 100 * eps) * torch.max(torch.abs(torch.diagonal(A)))
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    lu_s, piv_s, _info_s = torch.linalg.lu_factor_ex(A + shift * eye)
    robust = torch.zeros_like(lam)
    for _ in range(KKT_REFINE_PASSES):
        robust = robust + torch.linalg.lu_solve(lu_s, piv_s, (b - A @ robust)[:, None])[:, 0]
    return torch.where(refined, robust, lam), finite, refined


class _KKTSolve(torch.autograd.Function):
    """:func:`_solve_with_rescue`, one system per member under ``torch.func.vmap``.

    PyTorch factors a batch of matrices with other LU routines than one
    matrix, and so would a batched product; the KKT systems are
    ill-conditioned (C5), which turns an ulp there into 1e-10 of the
    projection.  The ``vmap`` rule solves each member's system as the
    single call does, so member m's multipliers are the bits of its own
    call's.
    """

    @staticmethod
    def forward(A, b):
        return _solve_with_rescue(A, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def vmap(info, in_dims, A, b):
        A = A.movedim(in_dims[0], 0) if in_dims[0] is not None else A.expand(
            info.batch_size, *A.shape)
        b = b.movedim(in_dims[1], 0) if in_dims[1] is not None else b.expand(
            info.batch_size, *b.shape)
        outs = [_solve_with_rescue(A[m], b[m]) for m in range(info.batch_size)]
        return tuple(torch.stack(x) for x in zip(*outs)), (0, 0, 0)


def solve_kkt_with_rescue(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the (already 1e-18-regularized) KKT normal equations.

    LU with partial pivoting, as the JAX package's CPU path.  Exactly
    duplicated or negated rows make A singular; the solve then yields
    non-finite multipliers, and the projection is skipped for that step by
    zeroing them (no exception: the ``_ex`` factorization reports instead
    of raising).

    Rows that are dependent by construction (the rigid disk's pairwise
    distances on a planar disk span 2n - 3 of their 3n - 6 directions) leave
    A with a null space that the 1e-18 ridge does not lift above round-off.
    An LU pivot there can come out far below the round-off of b, and the
    multipliers then carry a huge null-space part (|lam| ~ 1e16) whose
    rounding in ``lam @ G`` is an O(1) error in the projection, in one LU
    and not in another on the same system.  Such a solution leaves a
    residual |A lam - b| far above round-off; where it exceeds
    ``KKT_RESIDUAL_RTOL`` max|b| the multipliers are recomputed from the
    factorization of A shifted by ``KKT_SHIFT`` max|diag A| and refined
    toward the regularized system (``KKT_REFINE_PASSES``): the range part
    converges to the same solution, the null part stays of the size of b,
    and the projection is the one a clean LU gives.  Both are computed on
    every call and one is selected on the device (no host sync); a solve
    with a small residual keeps the LU's multipliers bit for bit.  Under
    ``torch.func.vmap`` (the parameter sweep) each member's system is
    solved on its own (:class:`_KKTSolve`), the selection made per member.
    """
    lam, finite, refined = _KKTSolve.apply(A, b)
    if KKT_RECORD is not None:
        KKT_RECORD.append((finite, refined, torch.max(torch.abs(lam))))
    return lam


def project_gradient_kkt(grad: torch.Tensor, constraint_grads) -> torch.Tensor:
    """Project grad against the span of dense constraint gradients."""
    if constraint_grads is None:
        return grad
    k = constraint_grads.shape[0]
    flatg = grad.reshape(-1)
    G = constraint_grads.reshape(k, -1)
    # the dot products as sums of products, and the Gram matrix, each member's own call under
    # ``torch.func.vmap`` (the parameter sweep): a batched reduction or product adds in an
    # order PyTorch picks by the member count
    if k == 1:
        gC = G[0]
        norm_sq = member_sum(gC * gC)
        lam = torch.where(
            norm_sq > 1e-18, member_sum(flatg * gC) / torch.clamp(norm_sq, min=1e-18), 0.0
        )
        return (flatg - lam * gC).reshape(grad.shape)
    A = per_member(_gram, G) + 1e-18 * torch.eye(k, dtype=grad.dtype, device=grad.device)
    lam = solve_kkt_with_rescue(A, member_sum(G * flatg, 1))
    return (flatg - member_sum(lam[:, None] * G, 0)).reshape(grad.shape)


def _gram(G: torch.Tensor) -> torch.Tensor:
    return G @ G.T


def orthonormalize_local_normals(normals: torch.Tensor) -> torch.Tensor:
    """Per-vertex modified Gram-Schmidt over the m stacked constraint normals."""
    outs = []
    for j in range(normals.shape[1]):
        v = normals[:, j]
        for q in outs:
            v = v - torch.sum(v * q, dim=1, keepdim=True) * q
        nrm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        outs.append(torch.where(nrm > 1e-12, v / torch.clamp(nrm, min=1e-12), 0.0))
    return torch.stack(outs, dim=1)


def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (3 components) of ``a * b``, term by term: a contraction that
    a BLAS product would add in another order under ``torch.func.vmap``."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def apply_local_projection(vec: torch.Tensor, n_hat: torch.Tensor) -> torch.Tensor:
    """Project (..., 3) rows onto the complement of their orthonormal normals (..., m, 3),
    one normal after the other, as sums of products."""
    coeff = _dot_last(vec[..., None, :], n_hat)
    out = vec
    for j in range(n_hat.shape[-2]):
        out = out - coeff[..., j, None] * n_hat[..., j, :]
    return out


def _compact_dense(vals: torch.Tensor, dense_at_slots: torch.Tensor) -> torch.Tensor:
    return torch.einsum("iac,jiac->ij", vals, dense_at_slots)


def make_gradient_projector(spec: ProblemSpec) -> Callable | None:
    """Three-channel exact KKT projection, or None (no rows, or
    ``rim_slope_match_kkt_rows`` ``reference_exact`` on a rim lane with a
    disk group: no projection, as in the reference).

    1. Local per-vertex rows (pins): analytic projectors, O(Nv).
    2. Compact-support rows (rim matching): normal equations assembled from
       slot (value, row) pairs.
    3. Dense rows: the small dense solve.

    Channels 2 and 3 are solved jointly after premultiplying every row by
    the local projector.  A vertex may sit in several compact rows, so the
    compact correction is summed over a slot CSR in a fixed order
    (``vertex_sum.row_sum``), not scattered with atomics.  Where the compact
    builders' slot rows are fixed per topology (a slot that a state leaves
    out carries a zero value), the CSR is built once and kept with it; a
    builder whose rows follow the positions (``fixed_rows`` False: the rim's
    interpolated outer ring) has it built per call.
    """
    from membrane_solver_tpu_torch.constraints import get_constraint

    if spec.option("rim_slope_match_kkt_rows", "span_reduced").lower() == "reference_exact":
        rim_flags = spec.static_of("constraint:rim_slope_match_out", ("inactive",))
        if rim_flags[0] == "active" and len(rim_flags) > 1 and bool(rim_flags[1]):
            # the reference stacks the rim's in-rows as exact negations of
            # its out-rows; its joint KKT matrix is then singular and the
            # whole projection is skipped every step, which this mode keeps
            return None

    local_builders, compact_builders, dense_builders = [], [], []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        local = getattr(mod, "local_constraint_normals", None)
        if local is not None:
            local_builders.append(local)
            continue
        compact_maker = getattr(mod, "make_compact_constraint_rows", None)
        fn = compact_maker(spec) if compact_maker is not None else None
        if fn is not None:
            compact_builders.append(fn)
            continue
        maker = getattr(mod, "make_constraint_gradient_rows", None)
        fn = maker(spec) if maker is not None else getattr(mod, "constraint_gradient_rows", None)
        if fn is not None:
            dense_builders.append(fn)
    if not (local_builders or compact_builders or dense_builders):
        return None
    rows_fixed = all(getattr(fn, "fixed_rows", True) for fn in compact_builders)

    def project(grad, state, topo, params):
        n_hat = None
        if local_builders:
            blocks = [b for b in (fn(state, topo, params) for fn in local_builders) if b is not None]
            if blocks:
                n_hat = orthonormalize_local_normals(torch.cat(blocks, dim=1))
                grad = apply_local_projection(grad, n_hat)

        compact = [c for c in (fn(state, topo, params) for fn in compact_builders) if c is not None]
        dense = [r for r in (fn(state, topo, params) for fn in dense_builders) if r is not None]
        if not compact and not dense:
            return grad

        dense_rows = None
        if dense:
            dense_rows = torch.cat(dense)
            if n_hat is not None:
                dense_rows = torch.stack([apply_local_projection(r, n_hat) for r in dense_rows])
        if not compact:
            return project_gradient_kkt(grad, dense_rows)

        n_rows = grad.shape[0]
        s_max = max(c[0].shape[1] for c in compact)
        vs, rs = [], []
        for v, r in compact:
            pad = s_max - v.shape[1]
            vs.append(torch.nn.functional.pad(v, (0, 0, 0, pad)) if pad else v)
            rs.append(torch.nn.functional.pad(r, (0, pad)) if pad else r)
        vals = torch.cat(vs)  # (kc, s, 3)
        rows_c = torch.clamp(torch.cat(rs), 0, n_rows - 1)
        if n_hat is not None:
            vals = apply_local_projection(vals, n_hat[rows_c])  # n_hat[rows_c]: (kc, s, m, 3)

        kc = vals.shape[0]
        csr = (kept_slot_csr(topo, "kkt/compact_rows", rows_c, n_rows) if rows_fixed
               else slot_csr(rows_c, n_rows))
        # A_cc[i, j] = sum over slots (a, b) sharing a row of vals[i, a] . vals[j, b], and
        # b_c[i] = sum over slots of vals[i, a] . grad[row], as sums of products: the
        # ill-conditioned solve (C5) would turn another order under vmap into 1e-10
        eq = (rows_c[:, None, :, None] == rows_c[None, :, None, :]).to(grad.dtype)
        dots = _dot_last(vals[:, None, :, None, :], vals[None, :, None, :, :]) * eq
        slots = [(sa, sb) for sa in range(dots.shape[2]) for sb in range(dots.shape[3])]
        A_cc = dots[:, :, 0, 0]
        for sa, sb in slots[1:]:
            A_cc = A_cc + dots[:, :, sa, sb]
        slot_dots = _dot_last(vals, grad[rows_c])
        b_c = slot_dots[:, 0]
        for sa in range(1, slot_dots.shape[1]):
            b_c = b_c + slot_dots[:, sa]

        if dense_rows is None:
            A = A_cc + 1e-18 * torch.eye(kc, dtype=grad.dtype, device=grad.device)
            lam = solve_kkt_with_rescue(A, b_c)
            return grad - vertex_sum.row_sum((lam[:, None, None] * vals).reshape(-1, 3), csr)

        kd = dense_rows.shape[0]
        Gd = dense_rows.reshape(kd, -1)
        # the dense products, each member's own call under ``torch.func.vmap``
        A_dd = per_member(_gram, Gd)
        A_cd = per_member(_compact_dense, vals, dense_rows[:, rows_c])
        A = torch.cat(
            [torch.cat([A_cc, A_cd], dim=1), torch.cat([A_cd.T, A_dd], dim=1)]
        ) + 1e-18 * torch.eye(kc + kd, dtype=grad.dtype, device=grad.device)
        b = torch.cat([b_c, per_member(torch.matmul, Gd, grad.reshape(-1))])
        lam = solve_kkt_with_rescue(A, b)
        corr = vertex_sum.row_sum((lam[:kc, None, None] * vals).reshape(-1, 3), csr)
        corr = corr + per_member(torch.matmul, lam[kc:], Gd).reshape(grad.shape)
        return grad - corr

    return project


# ----------------------------------------------------------------------
# geometric constraint enforcement
# ----------------------------------------------------------------------
def make_constraint_enforcer(spec: ProblemSpec) -> Callable | None:
    """Return enforce(state, topo, params, context) -> state, or None.

    Contexts: "mesh_operation" (after mesh ops), "finalize", and "minimize"
    (each line-search trial).
    """
    from membrane_solver_tpu_torch.constraints import get_constraint

    enforcers = []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        maker = getattr(mod, "make_enforce", None)
        fn = maker(spec) if maker is not None else getattr(mod, "enforce", None)
        if fn is not None:
            enforcers.append((name, fn))
    if not enforcers:
        return None

    def enforce(state, topo, params, context="minimize"):
        for name, fn in enforcers:
            # the volume projection is skipped inside minimization when
            # volume_projection_during_minimization is off
            if (
                name == "volume"
                and context == "minimize"
                and not spec.volume_projection_during_minimization
            ):
                continue
            state = fn(state, topo, params, context=context)
        return state

    return enforce


def project_all_tilts(state: MeshState, topo: Topology) -> MeshState:
    """Tangent-project all three tilt fields onto the current surface."""
    geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
    nrm = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())
    return dataclasses.replace(
        state,
        tilts=dgeo.project_to_tangent(state.tilts, nrm),
        tilts_in=dgeo.project_to_tangent(state.tilts_in, nrm),
        tilts_out=dgeo.project_to_tangent(state.tilts_out, nrm),
    )


# ----------------------------------------------------------------------
# line search
# ----------------------------------------------------------------------
@dataclasses.dataclass
class LineSearchResult:
    success: bool
    new_step: float  # in the state's dtype
    energy: float  # accepted energy (or energy0 on failure)
    state: MeshState  # accepted state (or the baseline on failure)
    trials: int = 0  # trial states scored
    extra: float | None = None  # the caller's ``extra`` scalar, read with the slope


def armijo_line_search(
    energy_of_state: Callable,
    state: MeshState,
    grad: torch.Tensor,
    direction: torch.Tensor,
    step_size: float,
    energy0: float,
    movable: torch.Tensor,
    topo: Topology,
    state_of_trial: Callable,
    accept_rule: str = "armijo",
    extra: torch.Tensor | None = None,
    batched: bool = False,
    states_of_trials: Callable | None = None,
) -> LineSearchResult:
    """Armijo backtracking over the chain alpha0, alpha0 * 0.7, ... (10 candidates).

    Steps displacing a vertex by more than 0.3x the minimum edge length
    must not rotate any triangle normal by more than 0.5 rad nor collapse a
    triangle.  ``state_of_trial`` maps trial positions to the full trial
    state (constraint enforcement, tilt re-enforcement, the reduced line
    search's relax, tangent projection).  Under ``accept_rule``
    ``decrease_only`` (the reduced line search's option) a trial is accepted
    when its energy is at most ``energy0``: no descent test, no slope term.
    The scalar bookkeeping (step sizes, the Armijo threshold) runs on the
    host in the state's dtype, with the JAX package's operation order.  A
    0-dim ``extra`` tensor of the caller's comes back in the result, read
    in the one host read of the slope.

    Two forms take the same decisions and return the same bits.  The
    sequential form (``batched`` False: the CPU's, as in the JAX package)
    scores one candidate after another, each ending in a host read, and
    stops at the first accepted one.  The batched form (the JAX package's
    on an accelerator, and the port's on the card,
    ``utils/tuning.batched_line_search``) scores candidate 0 alone and, when
    it is rejected, every other candidate in one ``torch.func.vmap`` of
    trial positions -> normal-rotation check -> ``state_of_trial`` ->
    ``energy_of_state``, read in one host read; the first accepted one wins
    and its state is built again outside the map.  ``state_of_trial`` and
    ``energy_of_state`` must then run under the map (no host read), with
    every sum a candidate's single-call bits, as the sweep's member path does.
    A ``states_of_trials`` (trial positions (B, N, 3) -> the B trial states,
    each the bits of ``state_of_trial`` on its member) takes the map's place
    for the trial states: the reduced-energy search's, whose trials relax the
    tilts in one member-batched relax (a relax reads the host, which no map
    can); the normal-rotation check and ``energy_of_state`` stay mapped.
    """
    np_dtype = _np_dtype(state.positions.dtype)
    positions = state.positions
    min_edge = dgeo.min_edge_length(positions, topo.edge_rows, topo.edge_valid)
    dir_norms = torch.linalg.vector_norm(direction, dim=1)
    max_dir_norm_t = torch.max(torch.where(movable, dir_norms, 0.0))
    g_dot_d_t = torch.sum(grad * direction)
    read = torch.stack([min_edge, max_dir_norm_t, g_dot_d_t]
                       + ([] if extra is None else [extra.to(g_dot_d_t.dtype)])).tolist()
    min_edge, max_dir_norm, slope = (np_dtype(x) for x in read[:3])
    safe_limit = SAFE_STEP_FRACTION * min_edge if min_edge > 0 else np_dtype(np.inf)
    energy0 = np_dtype(energy0)
    alpha0 = np_dtype(step_size)
    alpha_max = LS_ALPHA_MAX_FACTOR * alpha0
    if accept_rule == "decrease_only":
        descent, slope = True, np_dtype(0.0)
    else:
        descent = slope < 0.0

    def trial_of(alpha):
        return torch.where(movable[:, None], positions + float(alpha) * direction, positions)

    if batched:
        success, alpha, acc_E, acc_state, trials = _batched_search(
            energy_of_state, state, direction, movable, topo, state_of_trial, trial_of,
            np_dtype, alpha0, energy0, slope, max_dir_norm, safe_limit, descent,
            states_of_trials)
    else:
        alpha = alpha0
        success = False
        acc_E, acc_state = energy0, state
        trials = 0
        for _k in range(LS_MAX_ITER if descent else 0):
            trial = trial_of(alpha)
            normals_ok = (alpha * max_dir_norm) < safe_limit or bool(
                dgeo.check_normal_rotation(
                    positions, trial, topo.tri_rows, topo.tri_valid, NORMAL_LIMIT_RADIANS
                )
            )
            accept = False
            if normals_ok:
                st = state_of_trial(trial)
                E_t = np_dtype(float(energy_of_state(st)))
                trials += 1
                accept = E_t <= energy0 + LS_C * alpha * slope
            if accept:
                success, acc_E, acc_state = True, E_t, st
                break
            alpha = alpha * np_dtype(LS_BETA)
            if alpha < LS_ALPHA_FLOOR:
                break
    if success:
        new_step = min(alpha * np_dtype(LS_GAMMA), alpha_max)
    elif descent:
        new_step = max(alpha * np_dtype(LS_BETA), alpha0 * np_dtype(LS_BETA))
    else:
        new_step = alpha0
    return LineSearchResult(success=success, new_step=new_step, energy=acc_E, state=acc_state,
                            trials=trials, extra=None if extra is None else read[3])


def _batched_search(energy_of_state, state, direction, movable, topo, state_of_trial,
                    trial_of, np_dtype, alpha0, energy0, slope, max_dir_norm, safe_limit,
                    descent, states_of_trials=None):
    """(success, final carried alpha, energy, state, trials scored) of the sequential loop,
    from candidate 0 alone and, on its rejection, the other candidates in one map (JAX
    ``jit_core.armijo_line_search``'s batched branch).

    The chain is the sequential multiply in the state's dtype; candidate k > 0
    counts only where the sequential loop reaches it (alpha_k >= the floor).
    A candidate within its safe limit skips the normal-rotation check, as in
    the sequential loop; the map computes the check only when some candidate
    needs it.  On failure the carried alpha is the last reached candidate's
    times beta (JAX's ``k_last``), as the sequential loop leaves it.
    """
    if not descent:
        return False, alpha0, energy0, state, 0
    alphas = [alpha0]
    for _ in range(LS_MAX_ITER - 1):
        alphas.append(alphas[-1] * np_dtype(LS_BETA))
    reached = [True] + [a >= LS_ALPHA_FLOOR for a in alphas[1:]]
    safe = [(a * max_dir_norm) < safe_limit for a in alphas]

    trial = trial_of(alpha0)
    st = state_of_trial(trial)
    E_t = energy_of_state(st)
    if safe[0]:
        E0_t, ok0 = np_dtype(E_t.item()), True
    else:
        ok_t = dgeo.check_normal_rotation(state.positions, trial, topo.tri_rows, topo.tri_valid,
                                          NORMAL_LIMIT_RADIANS)
        e, ok = torch.stack([E_t, ok_t.to(E_t.dtype)]).tolist()
        E0_t, ok0 = np_dtype(e), bool(ok)
    if ok0 and E0_t <= energy0 + LS_C * alpha0 * slope:
        return True, alpha0, E0_t, st, 1

    positions = state.positions
    check = not all(safe[1:])

    def score(alpha):
        trial = torch.where(movable[:, None], positions + alpha * direction, positions)
        E = energy_of_state(state_of_trial(trial))
        if not check:
            return E
        ok = dgeo.check_normal_rotation(positions, trial, topo.tri_rows, topo.tri_valid,
                                        NORMAL_LIMIT_RADIANS)
        return torch.stack([E, ok.to(E.dtype)])

    tail = torch.tensor(alphas[1:], dtype=positions.dtype, device=positions.device)
    if states_of_trials is None:
        out = torch.func.vmap(score)(tail).tolist()
    else:
        trials_p = torch.where(movable[:, None], positions + tail[:, None, None] * direction,
                               positions)
        E = torch.func.vmap(energy_of_state)(states_of_trials(trials_p))
        if check:
            ok = torch.func.vmap(dgeo.check_normal_rotation, in_dims=(None, 0, None, None, None))(
                positions, trials_p, topo.tri_rows, topo.tri_valid, NORMAL_LIMIT_RADIANS)
            E = torch.stack([E, ok.to(E.dtype)], dim=1)
        out = E.tolist()
    trials = LS_MAX_ITER
    for k, row in enumerate(out, start=1):
        E_k, ok_k = (row, 1.0) if not check else row
        ok_k = safe[k] or ok_k != 0.0
        if reached[k] and ok_k and np_dtype(E_k) <= energy0 + LS_C * alphas[k] * slope:
            return True, alphas[k], np_dtype(E_k), state_of_trial(trial_of(alphas[k])), trials
    k_last = sum(reached) - 1
    return False, alphas[k_last] * np_dtype(LS_BETA), energy0, state, trials


# ----------------------------------------------------------------------
# steppers (functional state)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class StepperState:
    """Carry for CG (prev grad/direction) and BFGS (prev x + dense H^-1).

    GD ignores everything.  The tensors are at the exact vertex count (the
    port has no capacity padding); the H block exists only for BFGS.  The
    two counters are host values: the eager loop decides success on the
    host, so reading them costs no device sync.
    """

    prev_grad: torch.Tensor  # (Nv, 3)
    prev_dir: torch.Tensor  # (Nv, 3)  [CG]
    prev_x: torch.Tensor | None  # (Nv, 3)  [BFGS]
    H: torch.Tensor | None  # (3Nv, 3Nv) inverse-Hessian approx [BFGS]
    have_prev: bool
    iter_count: int  # successful steps since last reset


def fresh_stepper_state(n_vertices: int, kind: str = "gradient_descent", *,
                        dtype=torch.float64, device="cpu") -> StepperState:
    z = torch.zeros((n_vertices, 3), dtype=dtype, device=device)
    bfgs = kind == "bfgs"
    return StepperState(
        prev_grad=z,
        prev_dir=z,
        prev_x=z if bfgs else None,
        H=torch.eye(3 * n_vertices, dtype=dtype, device=device) if bfgs else None,
        have_prev=False,
        iter_count=0,
    )


CG_RESTART_INTERVAL = 10


def stepper_direction(
    kind: str,
    grad: torch.Tensor,
    ss: StepperState,
    fixed_mask: torch.Tensor,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, StepperState]:
    """Descent direction for the active stepper kind.

    - CG: *per-vertex-row* Polak-Ribiere beta with per-row reset to
      steepest descent where beta < 0; full restart to -g with no history
      or every 10th successful step; fixed rows zeroed.
    - BFGS: dense inverse-Hessian over movable DOFs (full-size with masked
      s/y so fixed rows stay at identity), update V H V^T + rho s s^T when
      the curvature condition y.s > 1e-12 holds, else reset H to identity;
      direction -H g.  The condition is taken on the device (``where``), so
      the update costs no host read.

    Returns (direction, mid-state).  BFGS replaces H at direction time;
    prev_x/prev_grad are stored only on success
    (:func:`stepper_update_on_success`).
    """
    if kind == "gradient_descent":
        return -grad, ss
    if kind == "conjugate_gradient":
        if not ss.have_prev or ss.iter_count % CG_RESTART_INTERVAL == 0:
            direction = -grad
        else:
            numer = torch.sum(grad * (grad - ss.prev_grad), dim=1)
            denom = torch.sum(ss.prev_grad * ss.prev_grad, dim=1) + 1e-20
            beta_pr = numer / denom
            cg_dir = -grad + beta_pr[:, None] * ss.prev_dir
            direction = torch.where((beta_pr < 0)[:, None], -grad, cg_dir)
        return torch.where(fixed_mask[:, None], 0.0, direction), ss
    if kind == "bfgs":
        n = grad.shape[0]
        movable = (~fixed_mask)[:, None].to(grad.dtype)
        g = (grad * movable).reshape(-1)
        H_after = ss.H
        if ss.have_prev:
            x = (positions * movable).reshape(-1)
            s = x - (ss.prev_x * movable).reshape(-1)
            y = g - (ss.prev_grad * movable).reshape(-1)
            ys = torch.dot(y, s)
            eye = torch.eye(3 * n, dtype=grad.dtype, device=grad.device)
            rho = 1.0 / ys
            V = eye - rho * torch.outer(s, y)
            updated = V @ ss.H @ V.T + rho * torch.outer(s, s)
            H_after = torch.where(ys > 1e-12, updated, eye)
        direction = -(H_after @ g).reshape(n, 3)
        direction = torch.where(fixed_mask[:, None], 0.0, direction)
        return direction, dataclasses.replace(ss, H=H_after)
    raise ValueError(f"unknown stepper kind {kind!r}")


def stepper_update_on_success(
    kind: str,
    ss: StepperState,
    grad: torch.Tensor,
    direction: torch.Tensor,
    positions: torch.Tensor,
) -> StepperState:
    if kind == "gradient_descent":
        return ss
    return dataclasses.replace(
        ss,
        prev_grad=grad,
        prev_dir=direction,
        prev_x=positions if ss.prev_x is not None else None,
        have_prev=True,
        iter_count=ss.iter_count + 1,
    )


# ----------------------------------------------------------------------
# the minimize block
# ----------------------------------------------------------------------
@dataclasses.dataclass
class MinimizeStats:
    iterations: int
    energy: float  # last assembled energy (pre-step of the final iteration)
    accepted_energy: float
    grad_norm: float
    step_size: float
    step_success: bool
    converged: bool
    terminated_early: bool  # zero-step exit
    zero_step_counter: int
    trials: int = 0  # line-search trial states scored
    accepted_steps: int = 0  # line searches that accepted a step
    trace_z_fallbacks: int = 0  # rejected steps retried along the trace rows' -dE/dz


@dataclasses.dataclass(frozen=True)
class MinimizeOptions:
    """Switches for a minimize block."""

    stepper: str = "gradient_descent"
    step_size_mode: str = "adaptive"  # or "fixed"
    enforce_in_line_search: bool = False
    # lagrange mode without per-trial geometric volume projection: check the
    # post-step volume drift and hard-project when it exceeds volume_tolerance
    volume_drift_check: bool = False


def volume_drift(positions, topo) -> torch.Tensor:
    """The largest relative volume error of the bodies with a target volume (0-dim)."""
    vols = dgeo.body_volumes(positions, topo.tri_rows, topo.tri_valid, topo.tri_body,
                             topo.body_valid.shape[0])
    target = topo.body_target_volume
    rel = torch.abs(vols - target) / torch.clamp(torch.abs(target), min=1.0)
    return torch.max(torch.where(topo.body_valid & topo.body_has_target, rel, 0.0))


def scalar_param(params, key, default: float) -> float:
    """The host value of the 0-dim parameter ``key``, else ``default``."""
    value = params.get(key)
    return default if value is None else value.item()


def make_guarded_relax(spec: ProblemSpec) -> Callable:
    """The per-iteration leaflet relax: relax(state, topo, params, n_inner) -> state.

    JAX ``_guarded_relax_body``: with ``tilt_relax_energy_guard_factor`` > 0
    (the static ``tilt_guard`` option), each attempt relaxes from the
    entry state and is kept when the total energy after it is at most
    max(guard_min, |E before| * factor); on a spike the tilt step is halved
    and the relax retried, ``tilt_relax_energy_guard_retries`` (default 4)
    times, and when every attempt spikes the entry state is returned.  The
    minimize block runs it every iteration, and the minimizer before the
    theta_B scan on the scan's iterations.
    """
    from membrane_solver_tpu_torch.runtime import tilt_relax as _tr

    relax_fn = _tr.make_relax_leaflet_tilts(spec)
    total = make_total_energy(spec)
    guard_on = spec.option("tilt_guard", "off") == "on"

    def run(state, topo, params, n_inner):
        step = scalar_param(params, "tilt_step_size", 0.0)
        tol = scalar_param(params, "tilt_tol", 0.0)
        factor = params.get("tilt_relax_energy_guard_factor")
        if not (guard_on and factor is not None and factor.item() > 0.0):
            return relax_fn(state, topo, params, n_inner, step, tol)[0]
        with torch.no_grad():
            pre_E = total(state, topo, params)
        guard_min = params.get("tilt_relax_energy_guard_min", pre_E.new_zeros(()))
        threshold = torch.maximum(guard_min, torch.abs(pre_E) * factor)
        attempts = 1 + int(scalar_param(params, "tilt_relax_energy_guard_retries", 4.0))
        trial_step = _np_dtype(state.positions.dtype)(step)
        for _attempt in range(attempts):
            new_state, _stats = relax_fn(state, topo, params, n_inner, trial_step, tol)
            with torch.no_grad():
                post_E = total(new_state, topo, params)
            if bool(post_E <= threshold):
                return new_state
            trial_step = trial_step * 0.5
        return state

    return run


def minimize_block(spec: ProblemSpec, options: MinimizeOptions) -> Callable:
    """Return block(state, topo, params, ss, n_steps, ...) -> (state, ss, MinimizeStats).

    Per iteration: the guarded leaflet tilt relax or the single-field tilt
    relax (``tilt_solve_mode`` nested or coupled; none when fixed), energy
    and projected shape gradient, the stepper's descent direction from its
    state ``ss``, Armijo line search with per-trial constraint enforcement,
    zero-step bookkeeping.  The stepper keeps its history only after an accepted step
    that took no drift projection, and starts afresh otherwise.  The line search
    takes its batched form where ``utils/tuning.batched_line_search`` says so for the
    state's device (the card), the reduced-energy search's included: its candidates 1-9
    relax their tilts in one member-batched relax (:data:`REDUCED_LS_FORM`); the
    baseline's relax stays single.

    ``shape_scaffold_rejected_step_fallback`` ``trace_z`` (with the compiled
    ``core:scaffold_trace/mask``): when the line search rejects, it is run
    again from the same baseline along -dE/dz on the trace rows only
    (Armijo rule), if the mean of that direction's z over the trace rows is
    finite and positive; its result replaces the first one.  The mean is
    read in the first line search's one host read.
    """
    from membrane_solver_tpu_torch.runtime import tilt_relax as _tr

    total = make_total_energy(spec)
    energy_and_grad = make_energy_and_grad(spec)
    constraint_enforcer = make_constraint_enforcer(spec)
    enforcer = constraint_enforcer if options.enforce_in_line_search else None
    strong_enforcer = constraint_enforcer if options.volume_drift_check else None
    tilt_enforcer = _tr.make_tilt_enforcer(spec)
    relaxing = spec.option("tilt_solve_mode", "fixed").lower() in {"nested", "coupled"}
    leaflets = _tr.spec_uses_leaflet_tilts(spec)
    relax = make_guarded_relax(spec) if relaxing and leaflets else None
    vertex_relax = (
        _tr.make_relax_vertex_tilts(spec)
        if relaxing and not leaflets and _tr.spec_uses_vertex_tilts(spec) else None
    )
    project_tilts_after_step = relax is not None or _tr.spec_uses_vertex_tilts(spec)
    fixed_mode = options.step_size_mode == "fixed"
    # the reduced-energy line search: the baseline and every trial re-relax
    # both leaflet tilts before they are scored (without it, coupled
    # shape-plus-tilt directions score as energy increases)
    reduced_ls = relax is not None and spec.option(
        "line_search_reduced_energy", "").lower() in {"1", "true", "yes", "on"}
    accept_rule = "armijo"
    if reduced_ls:
        accept_rule = spec.option("line_search_reduced_accept_rule", "armijo").lower()
        if accept_rule not in ("armijo", "decrease_only"):
            raise ValueError(f"Unknown reduced-energy accept rule: {accept_rule!r}")
        relax_fn = _tr.make_relax_leaflet_tilts(spec)
        relax_members = _tr.make_relax_leaflet_tilts_members(spec)
    trace_z = spec.option("shape_scaffold_rejected_step_fallback", "off").lower() == "trace_z"

    def block(state, topo, params, ss, n_steps, step_size, fixed_step, tol,
              step_size_floor, max_zero_steps, zero_step_counter, tilt_inner_iters,
              skip_first_relax=0):
        """``skip_first_relax``: the minimizer ran this iteration's relax already (theta_B scan)."""
        np_dtype = _np_dtype(state.positions.dtype)
        movable = ~topo.fixed_mask
        kind = options.stepper
        # the line search's form on this device
        batched = batched_line_search(state.positions.device)
        if batched:
            from membrane_solver_tpu_torch.parallel.member_block import prime_ordered_levels

            # the ordered rows' levels, read from the host once, before any map
            prime_ordered_levels(spec, topo)
        if reduced_ls:
            # the reduced relax's budget, step and tolerance (one host read
            # each, per call; the parameters hold for the whole call)
            reduced_n = int(np.int32(scalar_param(
                params, "line_search_reduced_tilt_inner_steps", 10.0)))
            reduced_step = scalar_param(params, "tilt_step_size", 0.1)
            reduced_tol = scalar_param(params, "tilt_tol", 0.0)

        def state_of_trial(p):
            # geometric enforcement, tilt-constraint re-enforcement, the
            # reduced line search's bounded relax, then tangent re-projection
            # of the tilt fields on the trial surface; trials start from
            # ls_base (the reduced baseline's relaxed tilts, else the state)
            st = dataclasses.replace(ls_base, positions=p)
            if enforcer is not None:
                st = enforcer(st, topo, params, context="minimize")
                st = tilt_enforcer(st, topo, params)
            if reduced_ls:
                st, _stats = relax_fn(st, topo, params, reduced_n, reduced_step, reduced_tol)
            if project_tilts_after_step:
                st = project_all_tilts(st, topo)
            return st

        def each_state(fn, st):
            """``fn`` on every member of a member-axis state: mapped, or on a sharded topology
            (``parallel/tensor``) one member after another through its sharded single calls."""
            if not _tr.sharded(topo):
                return torch.func.vmap(fn)(st)
            outs = [fn(_tr.member_state(st, m)) for m in range(st.positions.shape[0])]
            return MeshState(*(torch.stack([getattr(o, f.name) for o in outs])
                               for f in dataclasses.fields(MeshState)))

        def states_of_trials(p):
            """``state_of_trial`` on each of B trial positions (B, N, 3), the reduced relax
            member-batched: the batched reduced search's member pass."""
            base = [getattr(ls_base, f) for f in ("tilts", "tilts_in", "tilts_out")]
            st = MeshState(p, *(t.expand((p.shape[0],) + tuple(t.shape)) for t in base))
            with torch.no_grad():
                if enforcer is not None:
                    st = each_state(lambda s: tilt_enforcer(
                        enforcer(s, topo, params, context="minimize"), topo, params), st)
                st, _stats = relax_members(st, topo, params, reduced_n, reduced_step,
                                           reduced_tol)
                if project_tilts_after_step:
                    st = each_state(lambda s: project_all_tilts(s, topo), st)
            return st

        def energy_of_state(st):
            with torch.no_grad():
                return total(st, topo, params)

        def volume_drifted(st) -> bool:
            """Some constrained body's relative volume error exceeds volume_tolerance."""
            max_rel = volume_drift(st.positions, topo)
            tol = params.get("volume_tolerance")
            tol = np_dtype(1e-3) if tol is None else np_dtype(tol.item())
            return bool(np_dtype(max_rel.item()) > tol)

        step_size = np_dtype(step_size)
        zero_steps = int(zero_step_counter)
        i = 0
        converged = terminated_early = False
        step_success = True
        last_E = last_acc_E = last_gnorm = np_dtype(0.0)
        trials = accepted = fallbacks = 0
        trace_mask = topo.extras.get("core:scaffold_trace/mask") if trace_z else None
        while i < n_steps:
            if relax is not None and not (i == 0 and skip_first_relax):
                state = relax(state, topo, params, tilt_inner_iters)
            elif vertex_relax is not None:
                state, _nacc = vertex_relax(
                    state, topo, params, tilt_inner_iters,
                    scalar_param(params, "tilt_step_size", 0.0),
                    scalar_param(params, "tilt_tol", 0.0),
                )
            E_t, grad = energy_and_grad(state, topo, params)
            E, gnorm = (np_dtype(x) for x in
                        torch.stack([E_t, torch.linalg.vector_norm(grad)]).tolist())
            i += 1
            last_E, last_gnorm = E, gnorm
            if gnorm < tol:
                converged, step_success, last_acc_E = True, True, E
                break
            step_in = np_dtype(fixed_step) if fixed_mode else step_size
            direction, ss_mid = stepper_direction(
                kind, grad, ss, topo.fixed_mask, state.positions
            )
            if reduced_ls:
                # the baseline relaxes first: its tilts set the Armijo
                # threshold, start every trial and stay on total failure
                # (the direction is not recomputed on it)
                ls_base, _stats = relax_fn(state, topo, params, reduced_n, reduced_step,
                                           reduced_tol)
                ls_base = project_all_tilts(ls_base, topo)
                ls_E0 = np_dtype(energy_of_state(ls_base).item())
            else:
                ls_base, ls_E0 = state, E
            fb_dir = dz_mean = None
            if trace_mask is not None:
                zero = torch.zeros_like(grad[:, 0])
                fb_dir = torch.stack([zero, zero, torch.where(trace_mask, -grad[:, 2], 0.0)],
                                     dim=1)
                n_trace = torch.clamp(tree_sum(trace_mask.to(grad.dtype)), min=1.0)
                dz_mean = tree_sum(fb_dir[:, 2]) / n_trace
            member_pass = states_of_trials if reduced_ls else None
            ls = armijo_line_search(
                energy_of_state, ls_base, grad, direction, step_in, ls_E0, movable, topo,
                state_of_trial, accept_rule, extra=dz_mean, batched=batched,
                states_of_trials=member_pass,
            )
            if fb_dir is not None and not ls.success and np.isfinite(ls.extra) and ls.extra > 0:
                fallbacks += 1
                trials += ls.trials
                ls = armijo_line_search(
                    energy_of_state, ls_base, grad, fb_dir, step_in, ls_E0, movable, topo,
                    state_of_trial, batched=batched, states_of_trials=member_pass,
                )
            base_positions = state.positions
            state = ls.state
            drifted = strong_enforcer is not None and ls.success and volume_drifted(state)
            if drifted:
                state = strong_enforcer(state, topo, params, context="mesh_operation")
            if kind != "gradient_descent":
                ss = (
                    stepper_update_on_success(kind, ss_mid, grad, direction, base_positions)
                    if ls.success and not drifted
                    else fresh_stepper_state(grad.shape[0], kind, dtype=grad.dtype,
                                             device=grad.device)
                )
            step_size = np_dtype(fixed_step) if fixed_mode else ls.new_step
            at_floor = step_size <= step_size_floor
            zero_steps = 0 if ls.success else (zero_steps + 1 if at_floor else 0)
            terminated_early = (not ls.success) and at_floor and zero_steps >= max_zero_steps
            step_success, last_acc_E = ls.success, ls.energy
            trials += ls.trials
            accepted += int(ls.success)
            if terminated_early:
                break

        stats = MinimizeStats(
            iterations=i,
            energy=float(last_E),
            accepted_energy=float(last_acc_E),
            grad_norm=float(last_gnorm),
            step_size=float(step_size),
            step_success=bool(step_success),
            converged=converged,
            terminated_early=terminated_early,
            zero_step_counter=zero_steps,
            trials=trials,
            accepted_steps=accepted,
            trace_z_fallbacks=fallbacks,
        )
        return state, ss, stats

    return block
