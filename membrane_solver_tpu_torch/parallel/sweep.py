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
``problem.params`` is dropped.

``device_mesh`` places the members on a list of devices, as the JAX
package's ``PartitionSpec(SWEEP_AXIS)`` shards the member axis: an ordered
sequence of torch devices (:func:`sweep_mesh`; a device may repeat and may
be the CPU).  B members split into contiguous groups of B/n in member
order, one per listed device; each group runs the member block on its
device with its own copy of the topology (one per distinct device, kept
with the topology, with its own ordered levels, corner CSR and kernel
workspaces).  Groups on distinct devices run at the same time, one host
thread per device, each launching on its device's current stream; groups
that share a device run in turn.  The block's host loop holds Python's
lock while it decides, so the threads overlap their device work and their
waits, not their host work; a process per device would overlap that too,
but would have to ship the topology, the states and the launch counts
between processes.  While ``jit_core.KKT_RECORD`` or
``member_block.TRACE_Z_RECORD`` is a list, every group runs in turn in the
calling thread, so the records keep their order.  Every member of a group
gets the bits of a one-member sweep of that member, as in an unplaced
sweep of any member count (``parallel/member_block``), so placing the
members on a device list changes no bit of them on one kind of device;
a group on the CPU runs the kernels' plain twins, another arithmetic.
Each group's block takes the line-search form of its own device
(``utils/tuning.batched_line_search``): batched on a card, sequential on
the CPU, with the same bits.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from membrane_solver_tpu_torch.device import shard
from membrane_solver_tpu_torch.device.state import CompiledProblem, MeshState, Topology
from membrane_solver_tpu_torch.kernels import _launch
from membrane_solver_tpu_torch.parallel import member_block
from membrane_solver_tpu_torch.runtime import jit_core

# while a list: per group of each placed run, (device, (first member, end), its kernel
# launches by "<module>.<key>")
GROUP_RECORD = None


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


def sweep_mesh(devices: Sequence) -> tuple:
    """The sweep's device mesh: ``devices`` as an ordered tuple of torch devices (a device may
    repeat, and may be the CPU)."""
    mesh = tuple(shard.as_device(d) for d in devices)
    if not mesh:
        raise ValueError("a sweep mesh needs at least one device")
    return mesh


def make_sweep_minimize(spec, options: jit_core.MinimizeOptions, device_mesh=None) -> Callable:
    """The member-batched minimize: (SweepBatch fields) -> (states, stepper states, stats).

    ``run(states, topo, params, stepper_states, n_steps, step_sizes,
    fixed_step, tol, floor, max_zero, zero_counters)``, the JAX sweep's
    arguments; every result carries a leading member axis (the stats as
    numpy arrays).  A spec with a module outside the batched set raises
    NotImplementedError naming it and the ROADMAP item that holds it.  With
    a ``device_mesh`` the members run in groups on its devices (the module
    docstring); a member count the mesh does not divide raises ValueError.
    """
    block = member_block.member_block(spec, options)

    def run(states, topo, params, stepper_states, n_steps, step_sizes, fixed_step,
            tol, floor, max_zero, zero_counters):
        return block(states, topo, params, stepper_states, n_steps, step_sizes, fixed_step,
                     tol, floor, max_zero, zero_counters)

    if device_mesh is None:
        return run
    mesh = sweep_mesh(device_mesh)

    def run_placed(states, topo, params, stepper_states, n_steps, step_sizes, fixed_step,
                   tol, floor, max_zero, zero_counters):
        B, n = states.positions.shape[0], len(mesh)
        if B % n:
            raise ValueError(f"{B} sweep members do not split over {n} devices")
        size = B // n
        step_sizes = np.asarray(torch.as_tensor(step_sizes).cpu()).reshape(B)
        zero_counters = np.asarray(torch.as_tensor(zero_counters).cpu()).reshape(B)

        def group(j: int):
            """Group j's block on its device: (its results, its launches there)."""
            device, lo, hi = mesh[j], j * size, (j + 1) * size
            before = _launch.launches_on(_index(device))
            out = block(_members(states, lo, hi, device), _replica(topo, device),
                        {k: v[lo:hi].to(device) for k, v in params.items()},
                        _members(stepper_states, lo, hi, device), n_steps,
                        step_sizes[lo:hi], fixed_step, tol, floor, max_zero,
                        zero_counters[lo:hi])
            after = _launch.launches_on(_index(device))
            return out, {k: c - before.get(k, 0) for k, c in after.items()
                         if c != before.get(k, 0)}

        def on_device(device, groups):
            if device.type == "cuda":
                with torch.cuda.device(device):
                    return [group(j) for j in groups]
            return [group(j) for j in groups]

        by_device: Dict[torch.device, list] = {}
        for j, device in enumerate(mesh):
            by_device.setdefault(device, []).append(j)
        recording = jit_core.KKT_RECORD is not None or member_block.TRACE_Z_RECORD is not None
        results = [None] * n
        if len(by_device) == 1 or recording:
            for j in range(n):
                (results[j],) = on_device(mesh[j], [j])
        else:
            with ThreadPoolExecutor(max_workers=len(by_device)) as pool:
                futures = {d: pool.submit(on_device, d, groups) for d, groups in by_device.items()}
                for d, groups in by_device.items():
                    for j, out in zip(groups, futures[d].result()):
                        results[j] = out
        if GROUP_RECORD is not None:
            GROUP_RECORD.extend((mesh[j], (j * size, (j + 1) * size), results[j][1])
                                for j in range(n))
        return _joined([r[0] for r in results], mesh[0])

    return run_placed


def _index(device: torch.device) -> int:
    """The card index of ``device`` (-1 for the CPU), as ``kernels/_launch`` counts."""
    return device.index if device.type == "cuda" else -1


def _replica(topo: Topology, device: torch.device) -> Topology:
    """``topo`` itself on its own device, else its copy on ``device``, kept with ``topo``."""
    if topo.tri_rows.device == device:
        return topo

    def make():
        fields = {f.name: getattr(topo, f.name).to(device)
                  for f in dataclasses.fields(Topology) if f.name != "extras"}
        return Topology(**fields, extras={k: v.to(device) for k, v in topo.extras.items()})

    return topo.kept(("sweep.replica", device), make)


def _members(carry, lo: int, hi: int, device):
    """Members [lo, hi) of a MeshState or StepperState, their tensors on ``device``."""
    def part(x):
        if x is None:
            return None
        return x[lo:hi].to(device) if isinstance(x, torch.Tensor) else np.asarray(x)[lo:hi]

    return type(carry)(**{f.name: part(getattr(carry, f.name))
                          for f in dataclasses.fields(carry)})


def _joined(results: list, first: torch.device) -> tuple:
    """The groups' (states, stepper states, stats) joined in member order, tensors on ``first``."""
    def join(parts):
        if parts[0] is None:
            return None
        if isinstance(parts[0], torch.Tensor):
            return torch.cat([p.to(first) for p in parts])
        return np.concatenate([np.asarray(p) for p in parts])

    return tuple(type(results[0][i])(**{
        f.name: join([getattr(r[i], f.name) for r in results])
        for f in dataclasses.fields(results[0][i])}) for i in range(3))


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
