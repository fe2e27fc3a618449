"""Minimization core: energy assembly, KKT projection, Armijo line search.

Eager counterpart of ``membrane_solver_tpu/runtime/jit_core.py``.  The JAX
package traces each function below under ``jax.jit`` and runs the outer
iteration as a fixed-shape ``lax.while_loop``; here the same steps run
eagerly, the loops are Python loops, and each loop decision reads a device
scalar.  Gradients come from autograd through the energy assembly.

Ported branches: gradient descent, fixed and adaptive step sizes, the
plain (unguarded) coupled tilt relax, the sequential line search.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.state import MeshState, ProblemSpec, Topology
from membrane_solver_tpu_torch.energy import get_module

# Armijo line-search constants (as in the JAX package)
LS_MAX_ITER = 10
LS_BETA = 0.7
LS_C = 1e-4
LS_GAMMA = 1.5
LS_ALPHA_MAX_FACTOR = 10.0
LS_ALPHA_FLOOR = 1e-8
SAFE_STEP_FRACTION = 0.3
NORMAL_LIMIT_RADIANS = 0.5


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


def _energy_fns(spec: ProblemSpec):
    out = []
    for name in active_energy_modules(spec):
        module = get_module(name)
        maker = getattr(module, "make_energy", None)
        out.append((name, maker(spec) if maker is not None else module.energy))
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


def solve_kkt_with_rescue(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the (already 1e-18-regularized) KKT normal equations.

    LU with partial pivoting, as the JAX package's CPU path.  Exactly
    duplicated or negated rows make A singular; the solve then yields
    non-finite multipliers, and the projection is skipped for that step by
    zeroing them (no exception: the ``_ex`` factorization reports instead
    of raising).
    """
    lu, piv, _info = torch.linalg.lu_factor_ex(A)
    lam = torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]
    return torch.where(torch.all(torch.isfinite(lam)), lam, torch.zeros_like(lam))


def project_gradient_kkt(grad: torch.Tensor, constraint_grads) -> torch.Tensor:
    """Project grad against the span of dense constraint gradients."""
    if constraint_grads is None:
        return grad
    k = constraint_grads.shape[0]
    flatg = grad.reshape(-1)
    G = constraint_grads.reshape(k, -1)
    if k == 1:
        gC = G[0]
        norm_sq = torch.dot(gC, gC)
        lam = torch.where(
            norm_sq > 1e-18, torch.dot(flatg, gC) / torch.clamp(norm_sq, min=1e-18), 0.0
        )
        return (flatg - lam * gC).reshape(grad.shape)
    A = G @ G.T + 1e-18 * torch.eye(k, dtype=grad.dtype, device=grad.device)
    lam = solve_kkt_with_rescue(A, G @ flatg)
    return (flatg - lam @ G).reshape(grad.shape)


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


def apply_local_projection(vec: torch.Tensor, n_hat: torch.Tensor) -> torch.Tensor:
    """Project (Nv, 3) rows onto the complement of each vertex's normals (Nv, m, 3)."""
    coeff = torch.einsum("vc,vmc->vm", vec, n_hat)
    return vec - torch.einsum("vm,vmc->vc", coeff, n_hat)


def make_gradient_projector(spec: ProblemSpec) -> Callable | None:
    """Three-channel exact KKT projection.

    1. Local per-vertex rows (pins): analytic projectors, O(Nv).
    2. Compact-support rows (rim matching): normal equations assembled from
       slot (value, row) pairs.
    3. Dense rows: the small dense solve.

    Channels 2 and 3 are solved jointly after premultiplying every row by
    the local projector.
    """
    from membrane_solver_tpu_torch.constraints import get_constraint

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
            nh = n_hat[rows_c]  # (kc, s, m, 3)
            coeff = torch.einsum("ksc,ksmc->ksm", vals, nh)
            vals = vals - torch.einsum("ksm,ksmc->ksc", coeff, nh)

        kc = vals.shape[0]
        eq = (rows_c[:, None, :, None] == rows_c[None, :, None, :]).to(grad.dtype)
        dots = torch.einsum("iac,jbc->ijab", vals, vals)
        A_cc = torch.sum(dots * eq, dim=(2, 3))
        b_c = torch.einsum("iac,iac->i", vals, grad[rows_c])

        if dense_rows is None:
            A = A_cc + 1e-18 * torch.eye(kc, dtype=grad.dtype, device=grad.device)
            lam = solve_kkt_with_rescue(A, b_c)
            corr = torch.zeros_like(grad).index_put(
                (rows_c,), lam[:, None, None] * vals, accumulate=True
            )
            return grad - corr

        kd = dense_rows.shape[0]
        Gd = dense_rows.reshape(kd, -1)
        A_dd = Gd @ Gd.T
        A_cd = torch.einsum("iac,jiac->ij", vals, dense_rows[:, rows_c])
        A = torch.cat(
            [torch.cat([A_cc, A_cd], dim=1), torch.cat([A_cd.T, A_dd], dim=1)]
        ) + 1e-18 * torch.eye(kc + kd, dtype=grad.dtype, device=grad.device)
        b = torch.cat([b_c, Gd @ grad.reshape(-1)])
        lam = solve_kkt_with_rescue(A, b)
        corr = torch.zeros_like(grad).index_put(
            (rows_c,), lam[:kc, None, None] * vals, accumulate=True
        )
        corr = corr + (lam[kc:] @ Gd).reshape(grad.shape)
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
            enforcers.append(fn)
    if not enforcers:
        return None

    def enforce(state, topo, params, context="minimize"):
        for fn in enforcers:
            state = fn(state, topo, params, context=context)
        return state

    return enforce


def project_all_tilts(state: MeshState, topo: Topology) -> MeshState:
    """Tangent-project all three tilt fields onto the current surface."""
    geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
    nrm = dgeo.vertex_normals(geo, topo.tri_rows, topo.tri_valid, state.positions.shape[0])
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
) -> LineSearchResult:
    """Armijo backtracking, sequential form.

    Steps displacing a vertex by more than 0.3x the minimum edge length
    must not rotate any triangle normal by more than 0.5 rad nor collapse a
    triangle.  ``state_of_trial`` maps trial positions to the full trial
    state (constraint enforcement, tilt re-enforcement, tangent
    projection).  The scalar bookkeeping (step sizes, the Armijo threshold)
    runs on the host in the state's dtype, with the JAX package's operation
    order.
    """
    np_dtype = _np_dtype(state.positions.dtype)
    positions = state.positions
    min_edge = dgeo.min_edge_length(positions, topo.edge_rows, topo.edge_valid)
    dir_norms = torch.linalg.vector_norm(direction, dim=1)
    max_dir_norm_t = torch.max(torch.where(movable, dir_norms, 0.0))
    g_dot_d_t = torch.sum(grad * direction)
    min_edge, max_dir_norm, slope = (
        np_dtype(x) for x in torch.stack([min_edge, max_dir_norm_t, g_dot_d_t]).tolist()
    )
    safe_limit = SAFE_STEP_FRACTION * min_edge if min_edge > 0 else np_dtype(np.inf)
    energy0 = np_dtype(energy0)
    alpha0 = np_dtype(step_size)
    alpha_max = LS_ALPHA_MAX_FACTOR * alpha0
    descent = slope < 0.0

    def trial_of(alpha):
        return torch.where(movable[:, None], positions + float(alpha) * direction, positions)

    alpha = alpha0
    success = False
    acc_E, acc_state = energy0, state
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
    return LineSearchResult(success=success, new_step=new_step, energy=acc_E, state=acc_state)


# ----------------------------------------------------------------------
# steppers
# ----------------------------------------------------------------------
def stepper_direction(kind: str, grad: torch.Tensor) -> torch.Tensor:
    """Descent direction of the stepper: gradient descent only.

    The projected gradient already has its fixed rows zeroed.  The JAX
    package's conjugate-gradient and BFGS directions are not ported.
    """
    if kind != "gradient_descent":
        raise NotImplementedError(f"stepper {kind!r} is not ported to membrane_solver_tpu_torch")
    return -grad


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


@dataclasses.dataclass(frozen=True)
class MinimizeOptions:
    """Switches for a minimize block."""

    stepper: str = "gradient_descent"
    step_size_mode: str = "adaptive"  # or "fixed"
    enforce_in_line_search: bool = False


def make_guarded_relax(spec: ProblemSpec) -> Callable:
    """The per-iteration leaflet relax: relax(state, topo, params, n_inner) -> state.

    The JAX package wraps it in an energy-spike guard when
    ``tilt_relax_energy_guard_factor`` > 0; that guard is not ported (its
    static option raises when the problem is compiled).
    """
    from membrane_solver_tpu_torch.runtime import tilt_relax as _tr

    relax_fn = _tr.make_relax_leaflet_tilts(spec)

    def run(state, topo, params, n_inner):
        step = params.get("tilt_step_size")
        tol = params.get("tilt_tol")
        new_state, _stats = relax_fn(
            state, topo, params, n_inner,
            0.0 if step is None else step.item(), 0.0 if tol is None else tol.item(),
        )
        return new_state

    return run


def minimize_block(spec: ProblemSpec, options: MinimizeOptions) -> Callable:
    """Return block(state, topo, params, n_steps, ...) -> (state, MinimizeStats).

    Per iteration: coupled leaflet tilt relax, energy and projected shape
    gradient, the stepper's descent direction, Armijo line search with
    per-trial constraint enforcement, zero-step bookkeeping.
    """
    from membrane_solver_tpu_torch.runtime import tilt_relax as _tr

    total = make_total_energy(spec)
    energy_vg = make_energy_vg(spec)
    gradient_projector = make_gradient_projector(spec)
    enforcer = make_constraint_enforcer(spec) if options.enforce_in_line_search else None
    tilt_enforcer = _tr.make_tilt_enforcer(spec)
    do_tilt_relax = _tr.spec_uses_leaflet_tilts(spec)
    relax = make_guarded_relax(spec) if do_tilt_relax else None
    fixed_mode = options.step_size_mode == "fixed"

    def value_and_grad_projected(state, topo, params):
        E, g = energy_vg(state.positions, state, topo, params)
        # the KKT projection sees the full gradient; fixed rows are zeroed after
        if gradient_projector is not None:
            g = gradient_projector(g, state, topo, params)
        return E, torch.where(topo.fixed_mask[:, None], 0.0, g)

    def block(state, topo, params, n_steps, step_size, fixed_step, tol,
              step_size_floor, max_zero_steps, zero_step_counter, tilt_inner_iters):
        np_dtype = _np_dtype(state.positions.dtype)
        movable = ~topo.fixed_mask

        def state_of_trial(p):
            # geometric enforcement, tilt-constraint re-enforcement, then
            # tangent re-projection of the tilt fields on the trial surface
            st = dataclasses.replace(state, positions=p)
            if enforcer is not None:
                st = enforcer(st, topo, params, context="minimize")
                st = tilt_enforcer(st, topo, params)
            if do_tilt_relax:
                st = project_all_tilts(st, topo)
            return st

        def energy_of_state(st):
            with torch.no_grad():
                return total(st, topo, params)

        step_size = np_dtype(step_size)
        zero_steps = int(zero_step_counter)
        i = 0
        converged = terminated_early = False
        step_success = True
        last_E = last_acc_E = last_gnorm = np_dtype(0.0)
        while i < n_steps:
            if relax is not None:
                state = relax(state, topo, params, tilt_inner_iters)
            E_t, grad = value_and_grad_projected(state, topo, params)
            E, gnorm = (np_dtype(x) for x in
                        torch.stack([E_t, torch.linalg.vector_norm(grad)]).tolist())
            i += 1
            last_E, last_gnorm = E, gnorm
            if gnorm < tol:
                converged, step_success, last_acc_E = True, True, E
                break
            step_in = np_dtype(fixed_step) if fixed_mode else step_size
            direction = stepper_direction(options.stepper, grad)
            ls = armijo_line_search(
                energy_of_state, state, grad, direction, step_in, E, movable, topo,
                state_of_trial,
            )
            state = ls.state
            step_size = np_dtype(fixed_step) if fixed_mode else ls.new_step
            at_floor = step_size <= step_size_floor
            zero_steps = 0 if ls.success else (zero_steps + 1 if at_floor else 0)
            terminated_early = (not ls.success) and at_floor and zero_steps >= max_zero_steps
            step_success, last_acc_E = ls.success, ls.energy
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
        )
        return state, stats

    return block
