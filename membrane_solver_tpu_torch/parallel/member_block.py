"""The minimize block over a leading member axis: the parameter sweep's engine.

Counterpart of ``jax.vmap(jit_core._minimize_block_impl)`` as the JAX
package's ``parallel/sweep.py`` builds it: B members that share one
``Topology`` and one ``ProblemSpec`` and differ in their positions, tilts,
scalar parameters and step sizes run one block together.  As in the JAX
sweep, the block gets no ``tilt_inner_iters``: no tilt relax and no reduced
line search.  The tilts change only in the line search's trials: by the
tilt-constraint enforcement under ``enforce_in_line_search``, and, where an
energy module uses the single tilt field, by the tangent re-projection of
every tilt field on the trial surface.  Per iteration: energy and projected
shape gradient, the stepper's direction, the Armijo line search (with its
per-trial enforcement), on a ``trace_z`` lane the rejected-step fallback
(a second search along -dE/dz of the trace rows, for the members whose
first search failed and whose mean trace-z descent is finite and positive,
as JAX's ``lax.cond`` under ``vmap`` selects it per member), the volume
drift check and the zero-step bookkeeping.

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
way.  Member m of a B-member block gives the bits of a one-member block
of member m, at any B: every sum and product on a member's path adds in
an order that does not depend on B.  Per-vertex sums go through the
member-axis vertex-sum kernel; whole-array sums through
``device/reduce.tree_sum``, or, where a module keeps its single call's
order, through ``device/reduce.member_sum`` (that call once per member);
3x3 products and the KKT assembly are written term by term
(``device/linalg``, ``jit_core``); dense solves and products run one call
per member (``jit_core._KKTSolve``, ``device/reduce.per_member``), as
PyTorch factors or multiplies a batch in another order than one matrix.
The block's own reductions over a member's row (the gradient norm, the
Armijo slope, BFGS's products) are :func:`member_dot` and
``device/reduce.each_member``.  So each module mapped over the members gives its
single calls' bits, and a member never feels the others.

The decisions follow the JAX package's ``vmap`` of its ``while_loop``s: the
loop runs while any member is active, and a member that has converged,
terminated early or run its ``n_steps`` keeps its carry.  Each host
decision the single-member block takes on a scalar reads a (B,) vector
instead, once; the Armijo threshold arithmetic runs on the host in the
state's dtype with the JAX package's operation order, per member.

The line search takes one of two forms, with the same bits, chosen per
block call by ``utils/tuning.batched_line_search`` for the state's device.
Sequential (the CPU's): each round scores one candidate of all B members
(one launch each) and keeps the results of those still searching, one
host read a round.  Batched (the card's; JAX's sweep on an accelerator,
whose outer ``vmap`` puts the batched search's candidates inside the
members): candidate 0 of all B members in one map, then candidates 1-9
of the members that rejected candidate 0 as one flattened axis of
9 x R rows, each row a (member, candidate) with its member's state and
parameters: three host reads a search.  A row's bits are those of its
member at that step size in the sequential round, since no member's
arithmetic depends on the member count or its place on the axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.reduce import each_member, tree_sum
from membrane_solver_tpu_torch.device.state import MeshState, ProblemSpec, occurrence_levels
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
from membrane_solver_tpu_torch.utils.tuning import batched_line_search

# the modules whose per-member code runs under ``vmap``: the kozlov lane's,
# the shape family (with the reference's placeholders and the fixed-row
# mask, which change nothing), the leaflet tilt-field family, then the
# local-interface family, the rigid disk and the physical-edge shells
ENERGY_MODULES = frozenset({
    "surface", "tilt_in", "tilt_out", "bending_tilt_in", "bending_tilt_out",
    "tilt_thetaB_contact_in",
    "bending", "volume", "gaussian_curvature", "line_tension", "body_area_penalty",
    "edge_length_penalty", "jordan_area", "expression", "dummy_module",
    "tilt", "tilt_smoothness", "tilt_coupling", "tilt_smoothness_leaflet",
    "tilt_smoothness_in", "tilt_smoothness_out", "tilt_splay_twist_in",
    "tilt_disk_target_in", "tilt_disk_target_out", "tilt_rim_source_in",
    "tilt_rim_source_out", "tilt_rim_source_bilayer", "tilt_disk_contact_in",
    "bending_tilt", "mean_curvature_tilt", "rim_slope_match_out",
    "curved_local_interface_law", "curved_local_interface_penalty"})
CONSTRAINT_MODULES = frozenset({
    "pin_to_plane", "pin_to_circle", "rim_slope_match_out", "tilt_thetaB_boundary_in",
    "volume", "global_area", "body_area", "perimeter", "fixed_plane", "fix_facet_area",
    "expression", "edge", "fix_facet_angle", "fix_vertex_position", "dummy_module",
    "tilt_leaflet_match_rim", "tilt_vector_match_rim",
    "curved_local_interface_hard", "curved_local_interface_match", "rigid_disk",
    "local_interface_shells"})
# the ROADMAP item that holds each module outside the batched set
PENDING_CONSTRAINT: dict = {}
# while a list: per block iteration of a ``trace_z`` lane, the (B,) host masks (live, fallback
# viable, fallback search accepted)
TRACE_Z_RECORD = None
# while a list: per member line search, its form and what it did: host reads, trial-energy maps
# ("maps"), the batched tail's rows and chunks
SEARCH_RECORD = None
# the batched search's tail: the bytes one chunk of rows may hold on the card (a sweep's
# gradient already holds ~1 GiB a kozlov L3 member), and one row's peak while its energy is
# scored, in words of the state's dtype per vertex and per triangle (30-51 measured on kozlov L3
# and the vesicle L5 at float64)
TAIL_CHUNK_BYTES = 6 * 2**30
TAIL_ROW_WORDS = 64


def check_batched_modules(spec: ProblemSpec) -> None:
    """Raise NotImplementedError naming the first module outside the batched set
    and the ROADMAP item that holds it."""
    for kind, names, batched, pending in (
            ("energy", jit_core.active_energy_modules(spec), ENERGY_MODULES, {}),
            ("constraint", spec.constraint_modules, CONSTRAINT_MODULES, PENDING_CONSTRAINT)):
        for name in names:
            if name not in batched:
                item = pending.get(name, "ROADMAP A6")
                raise NotImplementedError(
                    f"the parameter sweep does not batch the {kind} module {name!r} yet ({item})")


def prime_ordered_levels(spec: ProblemSpec, topo) -> None:
    """Build the occurrence levels of every constraint that adds repeated rows in order
    (``state.ordered_index_add``; its module's ``ordered_rows``) before any map: one host read
    of the rows each, kept with the topology, so no host read happens inside a map.  The
    members share the topology, so they share the levels; each level's ``index_add`` adds at
    most one value per (member, row)."""
    from membrane_solver_tpu_torch.constraints import get_constraint

    for name in dict.fromkeys(spec.constraint_modules):
        rows_of = getattr(get_constraint(name), "ordered_rows", None)
        for key, rows in ({} if rows_of is None else rows_of(topo)).items():
            topo.kept(("ordered_index_add", key), lambda rows=rows: occurrence_levels(rows))


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


def member_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) dot products of each member's row of ``a`` and ``b`` (B, ...), in a fixed halving
    tree along the row (``device/reduce.tree_sum``): a batched reduction over the members'
    rows adds in an order PyTorch picks by the member count."""
    return tree_sum((a * b).reshape(a.shape[0], -1), dim=1)


def member_norm(a: torch.Tensor) -> torch.Tensor:
    """(B,) 2-norms of each member's row of ``a``: :func:`member_dot` of it with itself."""
    return torch.sqrt(member_dot(a, a))


def _congruence(V: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    return V @ H @ V.T


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
        numer = jit_core._dot_last(grad, grad - ss.prev_grad)
        denom = jit_core._dot_last(ss.prev_grad, ss.prev_grad) + 1e-20
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
        ys = member_dot(y, s)
        eye = torch.eye(3 * n, dtype=grad.dtype, device=grad.device)
        rho = (1.0 / ys)[:, None, None]
        V = eye - rho * (s[:, :, None] * y[:, None, :])
        updated = each_member(_congruence, V, ss.H) + rho * (s[:, :, None] * s[:, None, :])
        H_new = torch.where((ys > 1e-12)[:, None, None], updated, eye)
        take = torch.as_tensor(ss.have_prev & live, device=grad.device)
        H_after = torch.where(take[:, None, None], H_new, ss.H)
        direction = -each_member(torch.mv, H_after, g).reshape(B, n, 3)
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
    extra: np.ndarray | None = None  # the (B,) ``extra`` vector, read with the first host read


def trial_positions(positions, direction, movable, alpha: np.ndarray) -> torch.Tensor:
    """Each row's trial positions at its step ``alpha`` (rows,), in the state's dtype."""
    alpha_t = torch.as_tensor(alpha, device=positions.device)[:, None, None]
    return torch.where(movable[None, :, None], positions + alpha_t * direction, positions)


def _rotation_ok(positions, trial, topo) -> torch.Tensor:
    """(rows,) True where no triangle normal of the row rotates past the limit
    (``dgeo.check_normal_rotation``)."""
    return vmap(dgeo.check_normal_rotation, in_dims=(0, 0, None, None, None))(
        positions, trial, topo.tri_rows, topo.tri_valid, NORMAL_LIMIT_RADIANS)


def tail_chunk_rows(topo, dtype) -> int:
    """The rows the batched search's tail scores in one map: ``TAIL_CHUNK_BYTES`` over one row's
    peak, ``TAIL_ROW_WORDS`` words of the state's dtype per vertex and per triangle."""
    n = topo.fixed_mask.shape[0] + topo.tri_rows.shape[0]
    row = TAIL_ROW_WORDS * n * torch.empty((), dtype=dtype).element_size()
    return max(1, TAIL_CHUNK_BYTES // row)


def member_line_search(energies, state_of_trial, states: MeshState, params: dict, grad,
                       direction, step_size, energy0, movable, topo, live, extra=None,
                       batched: bool = False) -> MemberLineSearch:
    """``jit_core.armijo_line_search`` for the members in ``live`` (B,), the others untouched.

    ``state_of_trial(positions, states, params)`` maps the rows' trial
    positions to their trial states and ``energies(states, params)`` scores
    them, each mapped over the rows' leading axis.  One host read of (min
    edge, max |d|, g.d) for all members (and of the (B,) tensor ``extra``,
    returned in the result).  Sequential form: then one host read per
    scoring round of the trial energies, and one of the normal-rotation
    checks in a round where some member steps beyond its safe limit.
    Batched form (``batched``): two more reads (:func:`_batched_search`).
    Both forms give every member the same accept flag, step, energy and
    state in bits; ``trials`` counts as the single-problem forms count.
    """
    np_dtype = jit_core._np_dtype(states.positions.dtype)
    positions = states.positions
    min_edge = vmap(dgeo.min_edge_length, in_dims=(0, None, None))(
        positions, topo.edge_rows, topo.edge_valid)
    dir_norms = torch.sqrt(jit_core._dot_last(direction, direction))
    max_dir = torch.max(torch.where(movable[None, :], dir_norms, 0.0), dim=1).values
    slope_t = member_dot(grad, direction)
    read = _host(min_edge, max_dir, slope_t, *(() if extra is None else (extra,)))
    min_edge, max_dir_norm, slope = (a.astype(np_dtype) for a in read[:3])
    safe_limit = np.where(min_edge > 0, np_dtype(SAFE_STEP_FRACTION) * min_edge,
                          np_dtype(np.inf)).astype(np_dtype)
    energy0 = np.asarray(energy0, dtype=np_dtype)
    alpha0 = np.asarray(step_size, dtype=np_dtype)
    alpha_max = np_dtype(LS_ALPHA_MAX_FACTOR) * alpha0
    descent = slope < 0.0
    searching = live & descent
    record = {"form": "batched" if batched else "sequential", "reads": 1, "maps": 0,
              "rows": 0, "chunks": 0}
    if batched:
        success, alpha, acc_E, acc_state, trials = _batched_search(
            energies, state_of_trial, states, params, direction, movable, topo, np_dtype,
            alpha0, energy0, slope, max_dir_norm, safe_limit, searching, record)
    else:
        alpha = alpha0.copy()
        success = np.zeros_like(live)
        acc_E = energy0.copy()
        acc_state = states
        trials = np.zeros(live.shape[0], dtype=np.int64)
        dev = positions.device
        for _k in range(LS_MAX_ITER):
            if not searching.any():
                break
            trial = trial_positions(positions, direction, movable, alpha)
            normals_ok = (alpha * max_dir_norm) < safe_limit
            if (searching & ~normals_ok).any():
                normals_ok = normals_ok | _host(_rotation_ok(positions, trial, topo))[0]
                record["reads"] += 1
            scored = searching & normals_ok
            accept = np.zeros_like(live)
            if scored.any():
                trial_states = state_of_trial(trial, states, params)
                E_t = _host(energies(trial_states, params))[0].astype(np_dtype)
                record["reads"] += 1
                record["maps"] += 1
                trials += scored
                accept = scored & (E_t <= energy0 + LS_C * alpha * slope)
                acc_E = np.where(accept, E_t, acc_E)
                acc_state = _select(torch.as_tensor(accept, device=dev), trial_states, acc_state)
            success |= accept
            rejected = searching & ~accept
            alpha = np.where(rejected, alpha * np_dtype(LS_BETA), alpha).astype(np_dtype)
            searching = rejected & ~(alpha < LS_ALPHA_FLOOR)
    if SEARCH_RECORD is not None:
        SEARCH_RECORD.append(record)
    new_step = np.where(
        success, np.minimum(alpha * np_dtype(LS_GAMMA), alpha_max),
        np.where(descent, np.maximum(alpha * np_dtype(LS_BETA), alpha0 * np_dtype(LS_BETA)),
                 alpha0)).astype(np_dtype)
    return MemberLineSearch(success=success, new_step=new_step, energy=acc_E, state=acc_state,
                            trials=trials, extra=read[3] if extra is not None else None)


def _members(states: MeshState, params: dict, rows: torch.Tensor) -> tuple:
    """The states and parameters of the members ``rows`` (a device index vector), one row each."""
    return (MeshState(*(getattr(states, f.name).index_select(0, rows)
                        for f in dataclasses.fields(MeshState))),
            {k: v.index_select(0, rows) for k, v in params.items()})


def _batched_search(energies, state_of_trial, states, params, direction, movable, topo,
                    np_dtype, alpha0, energy0, slope, max_dir_norm, safe_limit, searching,
                    record) -> tuple:
    """(success, carried alpha, energy, state, trials) of each member's sequential search, from
    candidate 0 of all members and then candidates 1-9 of those that rejected it: JAX
    ``jit_core.armijo_line_search``'s batched branch under the sweep's ``vmap``.

    Per member the chain, ``reached`` and ``safe`` of ``jit_core._batched_search``.
    Round 0 scores candidate 0 of all B members in the map the sequential
    form uses, one host read of the energies and, where some searching
    member steps beyond its safe limit, of the rotation checks.  The tail
    scores the R members that rejected it on one axis of R x 9 rows (member
    r's candidates 1-9 at rows 9r to 9r + 8, its state and parameters
    gathered to each), in chunks of :func:`tail_chunk_rows` rows whose
    energies (and rotation checks, where some row needs one) are joined on
    the device: one host read.  Each member's first reached candidate that
    is safe or keeps its normals, and passes the Armijo test, wins; the
    winners' states are built again at their steps through the B-member
    map.  A member that fails carries its last reached candidate's step
    times beta.  ``trials``: 1 where candidate 0 wins, ``LS_MAX_ITER`` once
    the tail is scored, 0 without descent, as the single batched search
    counts.
    """
    positions = states.positions
    dev = positions.device
    B = positions.shape[0]
    alphas, reached = jit_core.candidate_chain(alpha0, np_dtype)
    safe = (alphas * max_dir_norm[:, None]) < safe_limit[:, None]
    threshold = energy0[:, None] + LS_C * alphas * slope[:, None]
    alpha = alpha0.copy()
    acc_E = energy0.copy()
    if not searching.any():
        return np.zeros(B, dtype=bool), alpha, acc_E, states, np.zeros(B, dtype=np.int64)

    trial = trial_positions(positions, direction, movable, alpha0)
    trial_states = state_of_trial(trial, states, params)
    E_t = energies(trial_states, params)
    check = bool((searching & ~safe[:, 0]).any())
    read = _host(E_t, *((_rotation_ok(positions, trial, topo),) if check else ()))
    record["reads"] += 1
    record["maps"] += 1
    E0 = read[0].astype(np_dtype)
    ok0 = safe[:, 0] | (read[1] != 0 if check else False)
    success = searching & ok0 & (E0 <= threshold[:, 0])
    acc_E = np.where(success, E0, acc_E)
    acc_state = _select(torch.as_tensor(success, device=dev), trial_states, states)
    trials = np.where(searching, 1, 0).astype(np.int64)
    del trial, trial_states, E_t

    tail = np.flatnonzero(searching & ~success)
    if tail.size == 0:
        return success, alpha, acc_E, acc_state, trials
    K = LS_MAX_ITER - 1
    rows = np.repeat(tail, K)
    row_alpha = alphas[tail, 1:].reshape(-1)
    check = bool((~safe[tail, 1:]).any())
    chunk = tail_chunk_rows(topo, positions.dtype)
    parts = []
    for lo in range(0, rows.size, chunk):
        idx = torch.as_tensor(rows[lo:lo + chunk], device=dev)
        st, p = _members(states, params, idx)
        d = direction.index_select(0, idx)
        trial = trial_positions(st.positions, d, movable, row_alpha[lo:lo + chunk])
        E = energies(state_of_trial(trial, st, p), p)
        parts.append(torch.stack([E, _rotation_ok(st.positions, trial, topo).to(E.dtype)])
                     if check else E[None])
        record["maps"] += 1
        record["chunks"] += 1
    record["rows"] += int(rows.size)
    out = torch.cat(parts, dim=1)
    read = _host(*out.unbind(0))
    record["reads"] += 1
    E_tail = read[0].astype(np_dtype).reshape(tail.size, K)
    ok = safe[tail, 1:] | (read[1].reshape(tail.size, K) != 0 if check else False)
    passes = reached[tail, 1:] & ok & (E_tail <= threshold[tail, 1:])
    won = passes.any(axis=1)
    k_win = np.argmax(passes, axis=1)
    trials[tail] = LS_MAX_ITER
    winners, lost = tail[won], tail[~won]
    success[winners] = True
    alpha[winners] = alphas[winners, 1 + k_win[won]]
    acc_E[winners] = E_tail[won, k_win[won]]
    alpha[lost] = jit_core.failed_alpha(alphas[lost], reached[lost])
    if winners.size:
        rebuilt = state_of_trial(trial_positions(positions, direction, movable, alpha), states,
                                 params)
        tail_won = np.zeros(B, dtype=bool)
        tail_won[winners] = True
        acc_state = _select(torch.as_tensor(tail_won, device=dev), rebuilt, acc_state)
    return success, alpha, acc_E, acc_state, trials


def trace_z_direction(grad, trace_mask):
    """(fallback direction (B, N, 3), mean trace-z component (B,)): the ``trace_z`` fallback's.

    The direction moves only the trace rows, along -dE/dz; the mean sums
    through ``tree_sum``, so a member's value does not depend on B.
    """
    zero = torch.zeros_like(grad[..., 0])
    fb_z = torch.where(trace_mask[None, :], -grad[..., 2], 0.0)
    n_trace = torch.clamp(tree_sum(trace_mask.to(grad.dtype)), min=1.0)
    return torch.stack([zero, zero, fb_z], dim=2), tree_sum(fb_z, dim=1) / n_trace


def take_fallback(first: MemberLineSearch, fb: MemberLineSearch, viable) -> MemberLineSearch:
    """Per member: the fallback search's result where ``viable`` (B,), else the first's; the
    trials of both searches added."""
    pick = lambda a, b: np.where(viable, b, a)  # noqa: E731
    return MemberLineSearch(
        success=pick(first.success, fb.success), new_step=pick(first.new_step, fb.new_step),
        energy=pick(first.energy, fb.energy),
        state=_select(torch.as_tensor(viable, device=fb.state.positions.device), fb.state,
                      first.state),
        trials=first.trials + np.where(viable, fb.trials, 0))


def make_member_energy_and_grad(spec: ProblemSpec) -> Callable:
    """fn(states, topo, params) -> (E (B,), projected shape gradient (B, N, 3)).

    ``jit_core.make_energy_and_grad`` per member: the energy's vertex
    gradient, the KKT projection, the curved free-disk restriction, fixed
    rows zeroed.  The KKT solve picks the LU's or the shifted, refined
    multipliers per member on the device (``jit_core.solve_kkt_with_rescue``);
    while ``jit_core.KKT_RECORD`` is a list, each solve appends its flags and
    multiplier sizes as (B,) tensors.
    """
    energy_of_positions = jit_core.make_energy_of_positions(spec)
    finish = jit_core.make_gradient_finisher(spec)

    def finish_recorded(h, st, p, topo):
        """``finish`` and, per shape KKT solve it made, its (finite, refined, max|lam|) stacked:
        a tensor made inside the map leaves it only as an output."""
        saved, jit_core.KKT_RECORD = jit_core.KKT_RECORD, []
        try:
            g = finish(h, st, topo, p)
            return g, [torch.stack([f.to(g.dtype), r.to(g.dtype), m])
                       for f, r, m in jit_core.KKT_RECORD]
        finally:
            jit_core.KKT_RECORD = saved

    def energy_and_grad(states: MeshState, topo, params):
        x = states.positions.detach().requires_grad_(True)
        with torch.enable_grad():
            E = vmap(lambda y, st, p: energy_of_positions(y, st, topo, p))(x, states, params)
            (g,) = torch.autograd.grad(E.sum(), (x,))
        with torch.no_grad():
            if jit_core.KKT_RECORD is None:
                return E.detach(), vmap(lambda h, st, p: finish(h, st, topo, p))(g, states, params)
            g, solves = vmap(lambda h, st, p: finish_recorded(h, st, p, topo))(g, states, params)
            # per solve, (B,) flags and sizes: member m's are its own solve's
            jit_core.KKT_RECORD.extend((s[:, 0] != 0, s[:, 1] != 0, s[:, 2]) for s in solves)
            return E.detach(), g

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
    # the single block's ``project_tilts_after_step``, which holds without a relax
    project_tilts = _tr.spec_uses_vertex_tilts(spec)
    trace_z = spec.option("shape_scaffold_rejected_step_fallback", "off").lower() == "trace_z"
    fixed_mode = options.step_size_mode == "fixed"
    kind = options.stepper

    def block(states, topo, params, ss, n_steps, step_sizes, fixed_step, tol, step_size_floor,
              max_zero_steps, zero_counters):
        np_dtype = jit_core._np_dtype(states.positions.dtype)
        B = states.positions.shape[0]
        dev = states.positions.device
        # the line search's form on this device (a placed group's own)
        batched = batched_line_search(dev)
        movable = ~topo.fixed_mask
        prime_ordered_levels(spec, topo)
        n_steps, max_zero_steps = int(n_steps), int(max_zero_steps)
        fixed_step, tol = np_dtype(float(fixed_step)), float(tol)
        step_size_floor = float(step_size_floor)

        def energies(st, p):
            with torch.no_grad():
                return vmap(lambda s, q: total(s, topo, q))(st, p)

        def trial_member(s, p):
            if enforcer is not None:
                s = enforcer(s, topo, p, context="minimize")
                s = tilt_enforcer(s, topo, p)
            return jit_core.project_all_tilts(s, topo) if project_tilts else s

        def state_of_trial(x, st, p):
            """The trial states of trial positions ``x`` (rows, N, 3) from the rows' states
            ``st`` and parameters ``p``: enforced when the options say so, the tilts
            re-projected when a module uses the single field."""
            st = dataclasses.replace(st, positions=x)
            if enforcer is None and not project_tilts:
                return st
            with torch.no_grad():
                return vmap(trial_member)(st, p)

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
        fallbacks = np.zeros(B, dtype=np.int64)
        trace_mask = topo.extras.get("core:scaffold_trace/mask") if trace_z else None
        vol_tol = params.get("volume_tolerance")
        active = iterations < n_steps
        while active.any():
            E_t, grad = energy_and_grad(states, topo, params)
            gnorm_t = member_norm(grad)
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
                fb_dir = dz_mean = None
                if trace_mask is not None:
                    fb_dir, dz_mean = trace_z_direction(grad, trace_mask)
                ls = member_line_search(energies, state_of_trial, states, params, grad,
                                        direction, step_in, E, movable, topo, live,
                                        extra=dz_mean, batched=batched)
                if fb_dir is not None:
                    # the rejected-step fallback where the mean trace-z descent is positive
                    viable = live & ~ls.success & np.isfinite(ls.extra) & (ls.extra > 0)
                    taken = np.zeros(B, dtype=bool)
                    if viable.any():
                        fallbacks += viable
                        fb = member_line_search(energies, state_of_trial, states, params,
                                                grad, fb_dir, step_in, E, movable, topo, viable,
                                                batched=batched)
                        taken = viable & fb.success
                        ls = take_fallback(ls, fb, viable)
                    if TRACE_Z_RECORD is not None:
                        TRACE_Z_RECORD.append((live.copy(), viable, taken))
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
            trace_z_fallbacks=fallbacks,
        )
        return states, ss, stats

    return block
