"""Parameter sweeps: B members of one problem minimized together on one card.

Counterpart of ``membrane_solver_tpu/parallel/sweep.py``.  The reference has
no distributed execution; its embarrassingly parallel axis is parameter
sweeps (disk separations, theta_B scans, moduli).  The JAX package ``vmap``s
its minimize block over a batch of members that share one topology and
shards the member axis over a device mesh.  Here the members run one
member-batched block on one card (``parallel/member_block``): the energy,
its gradient and the projection of all B members are one ``torch.func.vmap``
whose kernels take a member axis, so B members cost about one member's host
time.

Members may differ in their initial positions, their scalar parameters
(moduli, stiffnesses, theta_B) and their step sizes; they share the
``Topology`` and the ``ProblemSpec``, so nothing is compiled per member.  As
in the JAX package, a member override whose key is not in
``problem.params`` is dropped.  Placing members on several cards
(``device_mesh``) is not ported yet (ROADMAP A6's multi-card sweep item).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from membrane_solver_tpu_torch.device.state import CompiledProblem, MeshState
from membrane_solver_tpu_torch.parallel import member_block
from membrane_solver_tpu_torch.runtime import jit_core

MULTI_CARD_ITEM = "ROADMAP A6: multi-card sweep placement"


@dataclasses.dataclass
class SweepBatch:
    """A batch of sweep members sharing one topology and spec."""

    problem: CompiledProblem  # the prototype (topology + spec)
    states: MeshState  # leading member axis on every field
    params: Dict[str, Any]  # leading member axis on every value
    n_members: int


def batch_problem(
    problem: CompiledProblem,
    member_params: Sequence[Dict[str, Any]],
    member_positions: Sequence[np.ndarray] | None = None,
) -> SweepBatch:
    """Stack sweep members from a prototype problem.

    ``member_params`` gives per-member overrides of scalar parameters; keys
    missing from a member fall back to the prototype's value, and keys that
    are not parameters of the prototype are ignored.
    """
    n = len(member_params)
    states = MeshState(*(torch.stack([getattr(problem.state, f.name)] * n)
                         for f in dataclasses.fields(MeshState)))
    if member_positions is not None:
        like = problem.state.positions
        pos = torch.stack([torch.as_tensor(np.asarray(p), dtype=like.dtype).to(like.device)
                           for p in member_positions])
        states = dataclasses.replace(states, positions=pos)

    params: Dict[str, Any] = {}
    for key, proto_val in problem.params.items():
        vals = [m.get(key, proto_val) for m in member_params]
        params[key] = torch.stack([torch.as_tensor(v, dtype=proto_val.dtype).to(proto_val.device)
                                   for v in vals])
    return SweepBatch(problem=problem, states=states, params=params, n_members=n)


def make_sweep_minimize(spec, options: jit_core.MinimizeOptions, device_mesh=None) -> Callable:
    """The member-batched minimize: (SweepBatch fields) -> (states, stepper states, stats).

    ``run(states, topo, params, stepper_states, n_steps, step_sizes,
    fixed_step, tol, floor, max_zero, zero_counters)``, the JAX sweep's
    arguments; every result carries a leading member axis (the stats as
    numpy arrays).  A spec with a module outside the batched set raises
    NotImplementedError naming it and the ROADMAP item that holds it; so
    does a ``device_mesh``.
    """
    if device_mesh is not None:
        raise NotImplementedError(
            f"placing sweep members on several cards is not ported yet ({MULTI_CARD_ITEM}); "
            "pass device_mesh=None to run every member on one card")
    block = member_block.member_block(spec, options)

    def run(states, topo, params, stepper_states, n_steps, step_sizes, fixed_step,
            tol, floor, max_zero, zero_counters):
        return block(states, topo, params, stepper_states, n_steps, step_sizes, fixed_step,
                     tol, floor, max_zero, zero_counters)

    return run


def run_sweep(
    problem: CompiledProblem,
    member_params: Sequence[Dict[str, Any]],
    n_steps: int,
    step_size: float = 1e-3,
    options: jit_core.MinimizeOptions | None = None,
    device_mesh=None,
    tol: float = 1e-6,
    member_positions: Sequence[np.ndarray] | None = None,
):
    """Convenience: batch, minimize.

    Returns (batched states, batched stepper states, batched stats).
    """
    options = options or jit_core.MinimizeOptions()
    run = make_sweep_minimize(problem.spec, options, device_mesh)
    batch = batch_problem(problem, member_params, member_positions=member_positions)
    n = batch.n_members
    like = problem.state.positions
    stepper_states = member_block.fresh_member_stepper(
        n, problem.n_vertices, options.stepper, dtype=like.dtype, device=like.device)
    return run(
        batch.states,
        problem.topo,
        batch.params,
        stepper_states,
        n_steps,
        np.full(n, step_size),
        step_size,
        tol,
        1e-8,
        10,
        np.zeros(n, dtype=np.int64),
    )
