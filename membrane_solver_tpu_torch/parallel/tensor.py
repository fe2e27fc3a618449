"""Vertex-sharded (tensor-parallel) energy, gradient and minimize block.

Counterpart of ``membrane_solver_tpu/parallel/tensor.py``.  The reference
has no model parallelism; its analog of "the model outgrowing one device"
is mesh growth under refinement.  The JAX package shards the triangle and
vertex axes of a compiled problem over a ``tp`` mesh axis and lets XLA
insert the collectives.  Here the mesh is an ordered tuple of torch
devices (:func:`tp_mesh`; a device may repeat and may be the CPU), and
:func:`shard_problem` attaches a shard plan (``device/shard``) to the
topology: contiguous, balanced triangle ranges, one per device, each with
its own triangle fields, corner CSR, kept caches and kernel workspaces on
that device, and contiguous owner ranges of the vertex rows.  The kernels'
entry points that take the sharded corner CSR run each shard's triangles
on its device: positions and tilts are copied to every shard device (the
all-gather), partial vertex sums are added in shard order on the rows'
owners (the reduce-scatter), per-triangle outputs are joined in triangle
order.  The vertex-level glue, the constraints and the solver run on the
first device, as XLA keeps that part replicated.  Autograd crosses
devices through ``.to()``; no process group is formed (both packages are
single-controller).

Use::

    mesh = tp_mesh(devices=["cuda:0"] * 4)   # or tp_mesh(8) on an 8-card host
    state, topo = shard_problem(p, mesh)
    E, g = tp_energy_and_grad(p.spec, mesh)(state, topo, p.params)
    g.full()                                  # the (N, 3) gradient on the first device
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from membrane_solver_tpu_torch.device import shard
from membrane_solver_tpu_torch.device.state import MeshState, Topology
from membrane_solver_tpu_torch.runtime import jit_core


def tp_mesh(n_devices: int | None = None, devices: Sequence | None = None) -> tuple:
    """An ordered tuple of torch devices: ``devices`` as given (repeats and the CPU allowed),
    else the first ``n_devices`` visible cards (all of them when None)."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"{n} cards asked for, {count} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    mesh = tuple(shard.as_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _plan_of(topo, mesh) -> shard.ShardPlan:
    plan = getattr(topo, "plan", None)
    if plan is None or plan.devices != tuple(mesh):
        raise ValueError("the topology is not sharded over this mesh; use shard_problem(p, mesh)")
    return plan


def shard_problem(problem, mesh: Sequence) -> tuple:
    """(state, topo) of ``problem`` for ``mesh``: the state and the full topology on the
    first device, the topology a ``ShardedTopology`` whose corner CSR carries the shard
    plan (the triangle shards on their devices, the vertex rows' owners).  Small per-body
    arrays stay whole."""
    mesh = tp_mesh(devices=mesh)
    first = mesh[0]
    state = MeshState(*(getattr(problem.state, f.name).to(first)
                        for f in dataclasses.fields(MeshState)))
    topo = problem.topo
    fields = {f.name: getattr(topo, f.name).to(first)
              for f in dataclasses.fields(Topology) if f.name != "extras"}
    sharded = shard.ShardedTopology(**fields,
                                    extras={k: v.to(first) for k, v in topo.extras.items()})
    sharded.plan = shard.make_plan(sharded, mesh)
    return state, sharded


@dataclasses.dataclass(frozen=True)
class ShardedRows:
    """(N, *w) rows held as contiguous blocks, each on its owner device: the counterpart
    of a JAX array sharded ``P(TP_AXIS, None)`` over the JAX package's ``tp`` axis."""

    blocks: tuple  # per owner, its rows [a, b) on its device
    ranges: tuple  # (a, b) per block
    first: torch.device

    @classmethod
    def split(cls, x: torch.Tensor, plan: shard.ShardPlan) -> "ShardedRows":
        return cls(blocks=tuple(x[a:b].to(d) for d, a, b in plan.owners),
                   ranges=tuple((a, b) for _d, a, b in plan.owners), first=plan.first)

    @property
    def devices(self) -> tuple:
        return tuple(b.device for b in self.blocks)

    def full(self) -> torch.Tensor:
        """The rows as one tensor on the first device."""
        return torch.cat([b.to(self.first) for b in self.blocks])


def tp_energy_and_grad(spec, mesh: Sequence) -> Callable:
    """``run(state, topo, params) -> (E, g)`` on a topology from :func:`shard_problem`.

    ``E`` is the total energy, a 0-dim tensor on the first device, and ``g``
    its position gradient (``jit_core.make_energy_vg``) as :class:`ShardedRows`
    on the vertex rows' owners.
    """
    mesh = tp_mesh(devices=mesh)
    vg = jit_core.make_energy_vg(spec)

    def run(state, topo, params):
        plan = _plan_of(topo, mesh)
        E, g = vg(state.positions, state, topo, params)
        return E, ShardedRows.split(g, plan)

    return run


def tp_minimize_block(spec, options, mesh: Sequence) -> Callable:
    """``jit_core.minimize_block`` on a state and topology from :func:`shard_problem`: its
    energy, gradient, relax and line-search evaluations go through the shards.

    The line search takes the form the first device's ``utils/tuning`` switch gives, as the
    one-device block does: in the batched form candidate 0 and the accepted trial go through
    the shards, and the other candidates' mapped evaluation runs unsharded on the first device
    (``device/shard``: no plan inside ``torch.func.vmap``), which the shards' bits equal.  The
    reduced-energy search's member pass relaxes its candidates together
    (``tilt_relax.make_relax_leaflet_tilts_members``), each member's energy, enforcement and
    projection through its own sharded single calls.
    """
    mesh = tp_mesh(devices=mesh)
    block = jit_core.minimize_block(spec, options)

    def run(state, topo, *args, **kw):
        _plan_of(topo, mesh)
        return block(state, topo, *args, **kw)

    return run


def shard_launches(topo) -> list:
    """Per shard of a sharded topology: (device, a copy of its kernel launch tally)."""
    return [(s.device, dict(s.launches)) for s in topo.plan.shards]
