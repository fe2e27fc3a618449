"""The minimize block over a leading member axis: the parameter sweep's engine.

Counterpart of ``jax.vmap(jit_core._minimize_block_impl)`` as the JAX
package's ``parallel/sweep.py`` builds it: B members that share one
``Topology`` and one ``ProblemSpec`` and differ in their positions, tilts,
scalar parameters and step sizes run one block together.  As in the JAX
sweep, the block gets no ``tilt_inner_iters``: no tilt relax, no reduced
line search, no tilt projection after a step.  Per iteration: energy and
projected shape gradient, the stepper's direction, the Armijo line search
(with its per-trial enforcement under ``enforce_in_line_search``), the
volume drift check and the zero-step bookkeeping.

The device work runs once for all members.  The energy and its gradient
are ``torch.func.vmap`` of the per-member energy (``in_dims`` 0 for the
state and the parameters; the topology is closed over) with autograd
taken through the map: the gradient of the members' summed energies,
whose backward seeds every member with 1, as the single-member gradient
does.  Inside the map the kernels' entry points take their autograd
Functions, whose ``vmap`` rules launch the member-axis kernels
(``kernels/tri_kernels``, ``kernels/vertex_sum``): one launch for all B
members, each member's result the bits of its own launch.  The projection,
the enforcement and the line search's geometry checks are mapped the same
way.  No Python loop over members touches the device.

The decisions follow the JAX package's ``vmap`` of its ``while_loop``s: the
loop runs while any member is active, and a member that has converged,
terminated early or run its ``n_steps`` keeps its carry.  Each host
decision the single-member block takes on a scalar reads a (B,) vector
instead, once; the Armijo threshold arithmetic runs on the host in the
state's dtype with the JAX package's operation order, per member.  Every
line-search round scores all B members (one launch each) and keeps the
results of those still searching.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.state import MeshState, ProblemSpec
from membrane_solver_tpu_torch.runtime import jit_core
from membrane_solver_tpu_torch.runtime import tilt_relax as _tr
from membrane_solver_tpu_torch.runtime.jit_core import (
    LS_ALPHA_FLOOR,
    LS_ALPHA_MAX_FACTOR,
    LS_BETA,
    LS_C,
    LS_GAMMA,
    LS_MAX_ITER,
    NORMAL_LIMIT_RADIANS,
    SAFE_STEP_FRACTION,
    MinimizeOptions,
    MinimizeStats,
    StepperState,
)

# the modules whose per-member code runs under ``vmap``: the kozlov lane's
ENERGY_MODULES = frozenset({"surface", "tilt_in", "tilt_out", "bending_tilt_in",
                            "bending_tilt_out", "tilt_thetaB_contact_in"})
CONSTRAINT_MODULES = frozenset({"pin_to_plane", "pin_to_circle", "rim_slope_match_out",
                                "tilt_thetaB_boundary_in"})
WIDEN_ITEM = "ROADMAP A6: widen the sweep's batched module set"


def check_batched_modules(spec: ProblemSpec) -> None:
    """Raise NotImplementedError naming the first module outside the batched set.

    The scaffold lanes' ``trace_z`` rejected-step fallback (a second line
    search per member) is not batched either.
    """
    if spec.option("shape_scaffold_rejected_step_fallback", "off").lower() == "trace_z":
        raise NotImplementedError(
            "the parameter sweep does not batch shape_scaffold_rejected_step_fallback "
            f"'trace_z' yet ({WIDEN_ITEM})")
    for name in jit_core.active_energy_modules(spec):
        if name not in ENERGY_MODULES:
            raise NotImplementedError(
                f"the parameter sweep does not batch the energy module {name!r} yet "
                f"({WIDEN_ITEM})")
    for name in spec.constraint_modules:
        if name not in CONSTRAINT_MODULES:
            raise NotImplementedError(
                f"the parameter sweep does not batch the constraint module {name!r} yet "
                f"({WIDEN_ITEM})")


def _select(mask: torch.Tensor, new: MeshState, old: MeshState) -> MeshState:
    """Per member: ``new`` where ``mask`` (B,), else ``old``."""
    return MeshState(*(torch.where(mask[:, None, None], getattr(new, f.name), getattr(old, f.name))
                       for f in dataclasses.fields(MeshState)))


def _host(*tensors) -> list:
    """One host read of several (B,) device vectors."""
    stacked = torch.stack([t.to(tensors[0].dtype) for t in tensors]).cpu().numpy()
    return list(stacked)


def fresh_member_stepper(members: int, n_vertices: int, kind: str, *, dtype,
                         device) -> StepperState:
    """``jit_core.fresh_stepper_state`` with a leading member axis (H is (B, 3N, 3N) for BFGS)."""
    z = torch.zeros((members, n_vertices, 3), dtype=dtype, device=device)
    bfgs = kind == "bfgs"
    eye = torch.eye(3 * n_vertices, dtype=dtype, device=device)
    return StepperState(
        prev_grad=z, prev_dir=z, prev_x=z if bfgs else None,
        H=eye.expand(members, -1, -1).clone() if bfgs else None,
        have_prev=np.zeros(members, dtype=bool), iter_count=np.zeros(members, dtype=np.int64),
    )


def member_direction(kind: str, grad, ss: StepperState, fixed_mask, positions, live):
    """``jit_core.stepper_direction`` per member: (direction (B, N, 3), mid-state).

    CG restarts (no history, or every ``CG_RESTART_INTERVAL``-th step) and
    the BFGS update (history present, curvature above 1e-12) are chosen per
    member on the device; members outside ``live`` (B,) keep their H.
    """
    if kind == "gradient_descent":
        return -grad, ss
    if kind == "conjugate_gradient":
        restart = ~ss.have_prev | (ss.iter_count % jit_core.CG_RESTART_INTERVAL == 0)
        numer = torch.sum(grad * (grad - ss.prev_grad), dim=2)
        denom = torch.sum(ss.prev_grad * ss.prev_grad, dim=2) + 1e-20
        beta_pr = numer / denom
        cg_dir = -grad + beta_pr[:, :, None] * ss.prev_dir
        cg_dir = torch.where((beta_pr < 0)[:, :, None], -grad, cg_dir)
        restart_t = torch.as_tensor(restart, device=grad.device)
        direction = torch.where(restart_t[:, None, None], -grad, cg_dir)
        return torch.where(fixed_mask[None, :, None], 0.0, direction), ss
    if kind == "bfgs":
        B, n = grad.shape[0], grad.shape[1]
        movable = (~fixed_mask)[None, :, None].to(grad.dtype)
        g = (grad * movable).reshape(B, -1)
        x = (positions * movable).reshape(B, -1)
        s = x - (ss.prev_x * movable).reshape(B, -1)
        y = g - (ss.prev_grad * movable).reshape(B, -1)
        ys = torch.einsum("bi,bi->b", y, s)
        eye = torch.eye(3 * n, dtype=grad.dtype, device=grad.device)
        rho = (1.0 / ys)[:, None, None]
        V = eye - rho * (s[:, :, None] * y[:, None, :])
        updated = V @ ss.H @ V.transpose(1, 2) + rho * (s[:, :, None] * s[:, None, :])
        H_new = torch.where((ys > 1e-12)[:, None, None], updated, eye)
        take = torch.as_tensor(ss.have_prev & live, device=grad.device)
        H_after = torch.where(take[:, None, None], H_new, ss.H)
        direction = -torch.einsum("bij,bj->bi", H_after, g).reshape(B, n, 3)
        direction = torch.where(fixed_mask[None, :, None], 0.0, direction)
        return direction, dataclasses.replace(ss, H=H_after)
    raise ValueError(f"unknown stepper kind {kind!r}")


def member_stepper_after(kind: str, ss_mid: StepperState, ss_old: StepperState, grad,
                         direction, positions, keep, reset) -> StepperState:
    """Per member: history stored where ``keep``, a fresh state where ``reset``, else ``ss_old``.

    ``keep`` and ``reset`` are disjoint (B,) host masks; members in neither
    (converged or inactive) keep their carry unchanged.
    """
    if kind == "gradient_descent":
        return ss_old
    dev = grad.device
    keep_t = torch.as_tensor(keep, device=dev)[:, None, None]
    reset_t = torch.as_tensor(reset, device=dev)[:, None, None]
    stepped_t = keep_t | reset_t

    def pick(stored, mid, old, fresh):
        return torch.where(keep_t, stored, torch.where(reset_t, fresh, torch.where(
            stepped_t, mid, old)))

    zero = torch.zeros_like(grad)
    H = None
    if ss_old.H is not None:
        eye = torch.eye(ss_old.H.shape[1], dtype=grad.dtype, device=dev)
        H = torch.where(reset_t, eye, torch.where(stepped_t, ss_mid.H, ss_old.H))
    return StepperState(
        prev_grad=pick(grad, ss_mid.prev_grad, ss_old.prev_grad, zero),
        prev_dir=pick(direction, ss_mid.prev_dir, ss_old.prev_dir, zero),
        prev_x=None if ss_old.prev_x is None else pick(positions, ss_mid.prev_x,
                                                       ss_old.prev_x, zero),
        H=H,
        have_prev=np.where(keep, True, np.where(reset, False, ss_old.have_prev)),
        iter_count=np.where(keep, ss_old.iter_count + 1, np.where(reset, 0, ss_old.iter_count)),
    )


@dataclasses.dataclass
class MemberLineSearch:
    success: np.ndarray  # (B,) bool
    new_step: np.ndarray  # (B,) in the state's dtype
    energy: np.ndarray  # accepted energy (energy0 where it failed)
    state: MeshState  # accepted states (the baseline where it failed)
    trials: np.ndarray  # (B,) trial states scored per member


def member_line_search(energies, state_of_trial, states: MeshState, grad, direction, step_size,
                       energy0, movable, topo, live) -> MemberLineSearch:
    """``jit_core.armijo_line_search`` for the members in ``live`` (B,), the others untouched.

    One host read of (min edge, max |d|, g.d) for all members, one per
    scoring round of the trial energies, and one of the normal-rotation
    checks in a round where some member steps beyond its safe limit.
    """
    np_dtype = jit_core._np_dtype(states.positions.dtype)
    positions = states.positions
    min_edge = vmap(dgeo.min_edge_length, in_dims=(0, None, None))(
        positions, topo.edge_rows, topo.edge_valid)
    dir_norms = torch.linalg.vector_norm(direction, dim=2)
    max_dir = torch.max(torch.where(movable[None, :], dir_norms, 0.0), dim=1).values
    slope_t = torch.sum(grad * direction, dim=(1, 2))
    min_edge, max_dir_norm, slope = (a.astype(np_dtype) for a in
                                     _host(min_edge, max_dir, slope_t))
    safe_limit = np.where(min_edge > 0, np_dtype(SAFE_STEP_FRACTION) * min_edge,
                          np_dtype(np.inf)).astype(np_dtype)
    energy0 = np.asarray(energy0, dtype=np_dtype)
    alpha0 = np.asarray(step_size, dtype=np_dtype)
    alpha_max = np_dtype(LS_ALPHA_MAX_FACTOR) * alpha0
    descent = slope < 0.0
    alpha = alpha0.copy()
    success = np.zeros_like(live)
    acc_E = energy0.copy()
    acc_state = states
    trials = np.zeros(live.shape[0], dtype=np.int64)
    searching = live & descent
    dev = positions.device
    for _k in range(LS_MAX_ITER):
        if not searching.any():
            break
        alpha_t = torch.as_tensor(alpha, device=dev)[:, None, None]
        trial = torch.where(movable[None, :, None], positions + alpha_t * direction, positions)
        normals_ok = (alpha * max_dir_norm) < safe_limit
        if (searching & ~normals_ok).any():
            rotation_ok = vmap(dgeo.check_normal_rotation, in_dims=(0, 0, None, None, None))(
                positions, trial, topo.tri_rows, topo.tri_valid, NORMAL_LIMIT_RADIANS)
            normals_ok = normals_ok | rotation_ok.cpu().numpy()
        scored = searching & normals_ok
        accept = np.zeros_like(live)
        if scored.any():
            trial_states = state_of_trial(trial)
            E_t = energies(trial_states).cpu().numpy().astype(np_dtype)
            trials += scored
            accept = scored & (E_t <= energy0 + LS_C * alpha * slope)
            acc_E = np.where(accept, E_t, acc_E)
            acc_state = _select(torch.as_tensor(accept, device=dev), trial_states, acc_state)
        success |= accept
        rejected = searching & ~accept
        alpha = np.where(rejected, alpha * np_dtype(LS_BETA), alpha).astype(np_dtype)
        searching = rejected & ~(alpha < LS_ALPHA_FLOOR)
    new_step = np.where(
        success, np.minimum(alpha * np_dtype(LS_GAMMA), alpha_max),
        np.where(descent, np.maximum(alpha * np_dtype(LS_BETA), alpha0 * np_dtype(LS_BETA)),
                 alpha0)).astype(np_dtype)
    return MemberLineSearch(success=success, new_step=new_step, energy=acc_E, state=acc_state,
                            trials=trials)


def make_member_energy_and_grad(spec: ProblemSpec) -> Callable:
    """fn(states, topo, params) -> (E (B,), projected shape gradient (B, N, 3)).

    ``jit_core.make_energy_and_grad`` per member: the energy's vertex
    gradient, the KKT projection, the curved free-disk restriction, fixed
    rows zeroed.
    """
    energy_of_positions = jit_core.make_energy_of_positions(spec)
    finish = jit_core.make_gradient_finisher(spec)

    def energy_and_grad(states: MeshState, topo, params):
        x = states.positions.detach().requires_grad_(True)
        with torch.enable_grad():
            E = vmap(lambda y, st, p: energy_of_positions(y, st, topo, p))(x, states, params)
            (g,) = torch.autograd.grad(E.sum(), (x,))
        with torch.no_grad():
            return E.detach(), vmap(lambda h, st, p: finish(h, st, topo, p))(g, states, params)

    return energy_and_grad


def member_block(spec: ProblemSpec, options: MinimizeOptions) -> Callable:
    """block(states, topo, params, ss, n_steps, step_sizes, fixed_step, tol, floor,
    max_zero_steps, zero_counters) -> (states, ss, MinimizeStats of (B,) arrays).

    The arguments of the JAX sweep's ``run``, each per-member one with a
    leading member axis: ``states`` (a MeshState of (B, N, 3) tensors),
    ``params`` ((B,) tensors), ``ss`` (:func:`fresh_member_stepper`),
    ``step_sizes`` and ``zero_counters`` (B,).
    """
    check_batched_modules(spec)
    total = jit_core.make_total_energy(spec)
    energy_and_grad = make_member_energy_and_grad(spec)
    constraint_enforcer = jit_core.make_constraint_enforcer(spec)
    enforcer = constraint_enforcer if options.enforce_in_line_search else None
    strong_enforcer = constraint_enforcer if options.volume_drift_check else None
    tilt_enforcer = _tr.make_tilt_enforcer(spec)
    fixed_mode = options.step_size_mode == "fixed"
    kind = options.stepper

    def block(states, topo, params, ss, n_steps, step_sizes, fixed_step, tol, step_size_floor,
              max_zero_steps, zero_counters):
        np_dtype = jit_core._np_dtype(states.positions.dtype)
        B = states.positions.shape[0]
        dev = states.positions.device
        movable = ~topo.fixed_mask
        n_steps, max_zero_steps = int(n_steps), int(max_zero_steps)
        fixed_step, tol = np_dtype(float(fixed_step)), float(tol)
        step_size_floor = float(step_size_floor)

        def energies(st):
            with torch.no_grad():
                return vmap(lambda s, p: total(s, topo, p))(st, params)

        def enforced_member(s, p):
            s = enforcer(s, topo, p, context="minimize")
            return tilt_enforcer(s, topo, p)

        def state_of_trial(p):
            """The trial states of trial positions (B, N, 3): enforced, when the options say so."""
            st = dataclasses.replace(states, positions=p)
            if enforcer is None:
                return st
            with torch.no_grad():
                return vmap(enforced_member)(st, params)

        step_size = np.asarray(torch.as_tensor(step_sizes).cpu(), dtype=np_dtype).reshape(B)
        zero_steps = np.asarray(torch.as_tensor(zero_counters).cpu(), dtype=np.int64).reshape(B)
        iterations = np.zeros(B, dtype=np.int64)
        converged = np.zeros(B, dtype=bool)
        terminated = np.zeros(B, dtype=bool)
        step_success = np.ones(B, dtype=bool)
        last_E = np.zeros(B, dtype=np_dtype)
        last_acc_E = np.zeros(B, dtype=np_dtype)
        last_gnorm = np.zeros(B, dtype=np_dtype)
        trials = np.zeros(B, dtype=np.int64)
        accepted = np.zeros(B, dtype=np.int64)
        vol_tol = params.get("volume_tolerance")
        active = iterations < n_steps
        while active.any():
            E_t, grad = energy_and_grad(states, topo, params)
            gnorm_t = torch.linalg.vector_norm(grad.reshape(B, -1), dim=1)
            E, gnorm = (a.astype(np_dtype) for a in _host(E_t, gnorm_t))
            iterations += active
            last_E = np.where(active, E, last_E)
            last_gnorm = np.where(active, gnorm, last_gnorm)
            now_converged = active & (gnorm < tol)
            converged |= now_converged
            step_success = np.where(now_converged, True, step_success)
            last_acc_E = np.where(now_converged, E, last_acc_E)
            live = active & ~now_converged
            if live.any():
                step_in = np.full(B, fixed_step, dtype=np_dtype) if fixed_mode else step_size
                direction, ss_mid = member_direction(kind, grad, ss, topo.fixed_mask,
                                                     states.positions, live)
                ls = member_line_search(energies, state_of_trial, states, grad, direction,
                                        step_in, E, movable, topo, live)
                new_states = _select(torch.as_tensor(live, device=dev), ls.state, states)
                drifted = np.zeros(B, dtype=bool)
                if strong_enforcer is not None:
                    tol_v = np_dtype(1e-3) if vol_tol is None else vol_tol.cpu().numpy()
                    with torch.no_grad():
                        max_rel = vmap(lambda x: jit_core.volume_drift(x, topo))(
                            new_states.positions).cpu().numpy().astype(np_dtype)
                    drifted = live & ls.success & (max_rel > tol_v)
                    if drifted.any():
                        with torch.no_grad():
                            projected = vmap(lambda s, p: strong_enforcer(
                                s, topo, p, context="mesh_operation"))(new_states, params)
                        new_states = _select(torch.as_tensor(drifted, device=dev), projected,
                                             new_states)
                ss = member_stepper_after(kind, ss_mid, ss, grad, direction, states.positions,
                                          keep=live & ls.success & ~drifted,
                                          reset=live & ~(ls.success & ~drifted))
                states = new_states
                new_step = np.full(B, fixed_step, dtype=np_dtype) if fixed_mode else ls.new_step
                step_size = np.where(live, new_step, step_size).astype(np_dtype)
                at_floor = step_size <= step_size_floor
                zero_steps = np.where(live, np.where(ls.success, 0, np.where(
                    at_floor, zero_steps + 1, 0)), zero_steps)
                early = live & ~ls.success & at_floor & (zero_steps >= max_zero_steps)
                terminated |= early
                step_success = np.where(live, ls.success, step_success)
                last_acc_E = np.where(live, ls.energy, last_acc_E)
                trials += np.where(live, ls.trials, 0)
                accepted += live & ls.success
            active = active & ~converged & ~terminated & (iterations < n_steps)

        stats = MinimizeStats(
            iterations=iterations, energy=last_E, accepted_energy=last_acc_E,
            grad_norm=last_gnorm, step_size=step_size, step_success=step_success,
            converged=converged, terminated_early=terminated, zero_step_counter=zero_steps,
            trials=trials, accepted_steps=accepted,
            trace_z_fallbacks=np.zeros(B, dtype=np.int64),
        )
        return states, ss, stats

    return block
