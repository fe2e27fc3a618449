"""The per-triangle work split over a list of devices: the vertex-sharded evaluation's plan.

Counterpart of the shardings the JAX package's ``parallel/tensor.py`` puts
on a compiled problem (the triangle axis over its ``tp`` mesh axis, the
vertex rows as ``P(TP_AXIS, None)``), from which XLA partitions the graph
and inserts the collectives.  PyTorch has no partitioner, so the port
places the work itself.  A :class:`ShardPlan` splits the T triangles into
contiguous, balanced ranges, one per listed device (a device may repeat,
and may be the CPU), each with its own :class:`Shard`: a topology on that
device with its slice of every triangle-indexed field, its own corner CSR
over all vertex rows (``state.corner_csr(shard tri_rows, n_vertices)``),
its own kept caches and kernel workspaces, and its own launch tally.  The
vertex rows get contiguous owner ranges, one per listed device.

The plan rides on the sharded topology (:class:`ShardedTopology`), whose
corner CSR (:class:`ShardedCSR`) carries it, so the kernels' entry points
that take that CSR (``tri_kernels.surface_energy``,
``surface_energy_and_gradient``, ``curvature_data``,
``p1_triangle_divergence``, ``frozen_tilt.frozen_tilt_energy`` and
``vertex_sum.vertex_sum``, which ``geo.scatter_add_rows`` calls) find it
(:func:`plan_of`) and run each shard's triangles on its device
(:meth:`ShardPlan.map`):

- vertex inputs are copied to every shard's device (:class:`_AllGather`,
  the all-gather); its backward adds the shards' gradients in shard order
  on the rows' owners (the reduce-scatter) and joins them on the first
  device;
- per-shard vertex sums are added in shard order on the rows' owners and
  joined on the first device (:meth:`ShardPlan.reduce_rows`), per-triangle
  outputs are joined in triangle order and scalars added in shard order
  there (:meth:`ShardPlan.join`, :meth:`ShardPlan.add`).

The rest of each module (vertex-level glue, constraints, sums) and the
solver run on the first device with the full topology, as XLA keeps that
part replicated.  Autograd crosses devices through ``.to()`` and
:class:`_AllGather`; no process group is formed.  Every sum adds in a fixed
order, so two runs give the same bits.  A CSR without a plan takes the
unsharded path unchanged, and so does a call under ``torch.func.vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from membrane_solver_tpu_torch.device.state import CornerCSR, Topology, corner_csr
from membrane_solver_tpu_torch.kernels import _launch

# shard boundaries fall on multiples of this many triangles, so a slice of a
# (T, 3, 3) float32 tensor starts 16-byte aligned, as the kernels' bulk loads need
ALIGN = 4


def as_device(device) -> torch.device:
    """``device`` as a ``torch.device``: a bare ``"cuda"`` resolved to the current card, any
    CPU device as ``cpu`` (tensors there all report ``cpu``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if device.type == "cpu" else device


def triangle_ranges(n_triangles: int, n_shards: int) -> list:
    """Contiguous, balanced [lo, hi) triangle ranges, one per shard, every inner boundary
    a multiple of :data:`ALIGN`; raises ValueError when a range would be empty."""
    bounds = [0] + [ALIGN * ((k * n_triangles) // (n_shards * ALIGN))
                    for k in range(1, n_shards)] + [n_triangles]
    ranges = list(zip(bounds[:-1], bounds[1:]))
    if any(hi <= lo for lo, hi in ranges):
        raise ValueError(f"{n_triangles} triangles do not fill {n_shards} shards of at least "
                         f"{ALIGN} triangles")
    return ranges


def shard_topology(topo: Topology, lo: int, hi: int, device) -> Topology:
    """A plain :class:`Topology` on ``device`` holding triangles [lo, hi) of ``topo``.

    Every triangle-indexed field (``tri_*``, and each extra whose leading
    axis is T, as the JAX package shards every leading axis the mesh
    divides) is sliced; the rest is copied whole.  Its own tensors, so its
    kept items (the corner CSR, the kernels' workspaces) are its own.
    """
    T = topo.tri_rows.shape[0]

    def tri(x):
        return x[lo:hi].to(device, memory_format=torch.contiguous_format, copy=True)

    fields = {f.name: (tri if f.name.startswith("tri_") else lambda x: x.to(device))(
        getattr(topo, f.name)) for f in dataclasses.fields(Topology) if f.name != "extras"}
    extras = {k: tri(v) if v.dim() >= 1 and v.shape[0] == T else v.to(device)
              for k, v in topo.extras.items()}
    return Topology(**fields, extras=extras)


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """Triangles [lo, hi) on ``device``: their topology, its corner CSR and its launch tally."""

    device: torch.device
    lo: int
    hi: int
    topo: Topology
    csr: CornerCSR
    launches: dict  # "<module>.<key>" -> kernel launches over ``csr`` (kernels/_launch)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardPlan:
    """The triangle shards and the vertex rows' owners of one sharded topology."""

    devices: tuple  # the mesh, in order; the first holds the glue and the results
    shards: tuple  # a Shard per device, in triangle order
    owners: tuple  # (device, a, b) per device: the vertex rows [a, b) it owns
    n_vertices: int
    n_triangles: int

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def map(self, fn: Callable, vertex: Sequence = (), tri: Sequence = (),
            shared: Sequence = ()) -> list:
        """``[fn(shard, *vertex_k, *tri_k, *shared_k) for each shard]``.

        ``vertex`` tensors go whole to every shard's device (through
        :class:`_AllGather`), ``tri`` tensors as the shard's triangle rows,
        ``shared`` ones whole (no gradient is summed back); None passes as
        None.
        """
        copies = [None if x is None else _AllGather.apply(x, self) for x in vertex]
        out = []
        for k, s in enumerate(self.shards):
            args = [None if c is None else c[k] for c in copies]
            args += [None if x is None else x[s.lo:s.hi].to(s.device) for x in tri]
            args += [None if x is None else x.to(s.device) for x in shared]
            out.append(fn(s, *args))
        return out

    def reduce_rows(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-shard (N, *w) vertex rows added in shard order on each row block's owner, the
        blocks joined on the first device (the reduce-scatter, then the glue's gather)."""
        blocks = []
        for device, a, b in self.owners:
            acc = None
            for p in parts:
                piece = p[a:b].to(device)
                acc = piece if acc is None else acc + piece
            blocks.append(acc.to(self.first))
        return torch.cat(blocks)

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-shard per-triangle outputs joined in triangle order on the first device."""
        return torch.cat([p.to(self.first) for p in parts])

    def add(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-shard scalars added in shard order on the first device."""
        acc = parts[0].to(self.first)
        for p in parts[1:]:
            acc = acc + p.to(self.first)
        return acc


def make_plan(topo: Topology, devices: Sequence) -> ShardPlan:
    """The :class:`ShardPlan` of ``topo`` over ``devices`` (an ordered sequence; may repeat)."""
    devices = tuple(as_device(d) for d in devices)
    if not devices:
        raise ValueError("a shard plan needs at least one device")
    T, N = topo.tri_rows.shape[0], topo.vertex_valid.shape[0]
    shards = []
    for device, (lo, hi) in zip(devices, triangle_ranges(T, len(devices))):
        st = shard_topology(topo, lo, hi, device)
        csr = st.corner_csr()
        launches: dict = {}
        _launch.keep_tally(csr, launches)
        shards.append(Shard(device=device, lo=lo, hi=hi, topo=st, csr=csr, launches=launches))
    n = len(devices)
    owners = tuple((d, (j * N) // n, ((j + 1) * N) // n) for j, d in enumerate(devices))
    return ShardPlan(devices=devices, shards=tuple(shards), owners=owners, n_vertices=N,
                     n_triangles=T)


@dataclasses.dataclass(frozen=True)
class ShardedCSR(CornerCSR):
    """The full corner CSR of a sharded topology, on its first device, with the plan."""

    plan: ShardPlan | None = None


@dataclasses.dataclass
class ShardedTopology(Topology):
    """A :class:`Topology` on the plan's first device whose corner CSR carries the plan."""

    plan: ShardPlan | None = None

    def corner_csr(self) -> CornerCSR:
        def make():
            full = corner_csr(self.tri_rows, self.vertex_valid.shape[0])
            return ShardedCSR(offsets=full.offsets, slots=full.slots, rows=full.rows,
                              plan=self.plan)

        return self.kept("corner_csr", make)


def plan_of(csr, like: torch.Tensor, rows: torch.Tensor) -> ShardPlan | None:
    """The plan ``csr`` carries, unless ``like`` is inside ``torch.func.vmap`` (no plan there).

    ``rows`` is the call's per-triangle input (``tri_rows``, or the corner
    rows of a vertex sum); a call over another triangle count raises.
    """
    plan = getattr(csr, "plan", None)
    if plan is None or torch._C._functorch.is_batchedtensor(like):
        return None
    if rows.shape[0] != plan.n_triangles:
        raise ValueError(f"the shard plan covers {plan.n_triangles} triangles; a call over "
                         f"{rows.shape[0]} passed the sharded corner CSR")
    return plan


class _AllGather(torch.autograd.Function):
    """A vertex tensor on the first device copied to every shard's device; the backward adds
    the shards' gradients in shard order on the rows' owners (``ShardPlan.reduce_rows``)."""

    @staticmethod
    def forward(ctx, x, plan: ShardPlan):
        ctx.set_materialize_grads(False)  # a shard that did not use its copy passes None
        ctx.plan, ctx.device = plan, x.device
        return tuple(x.view_as(x) if s.device == x.device else x.to(s.device)
                     for s in plan.shards)

    @staticmethod
    def backward(ctx, *grads):
        present = [g for g in grads if g is not None]
        if not present:
            return None, None
        return ctx.plan.reduce_rows(present).to(ctx.device), None
