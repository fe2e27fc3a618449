"""Deterministic corner-to-vertex sums: CUDA kernel wrapper and its plain twin.

Per-triangle kernels produce one row per triangle corner; the energy needs
them per vertex.  The vertex-sum kernel (``csrc/vertex_sum.cuh``: one
thread per vertex row with the loads of a chunk of :data:`CHUNK` corners in
flight at once) adds each vertex's corner rows in the order of the
topology's :class:`~membrane_solver_tpu_torch.device.state.CornerCSR`, so
the sums are the same bits on every run, where ``index_add`` on the card
adds with float atomics in a changing order.  The frozen-tilt, surface,
curvature-backward and divergence entry points launch it inside their own
calls (the divergence's tilt backward in its weighted form; the curvature
forward adds in the same order inside its own kernel), and their CPU
paths take :func:`reference`, which adds in the same order; :func:`launch` runs it
alone (``csrc/vertex_sum.cu``) on CUDA tensors, after device, dtype, shape
and contiguity checks that raise on anything else (the CSR's once per CSR
and device, :func:`check_csr`).

The plain modules sum through it too: :func:`vertex_sum` is the
differentiable entry (the kernel for a CUDA tensor, the twin for a CPU one;
its backward gathers through ``csr.rows``) behind ``geo.scatter_add_rows``,
and :func:`row_sum` adds K slot values into vertex rows over a
``state.slot_csr`` (the KKT corrections and the per-vertex constraint
normals, whose rows may repeat).
``LAUNCHES["vertex_sum"]`` counts every launch of the kernel, from this
module's wrapper and from the entry points that launch it.

The member axis (the parameter sweep, ``parallel/sweep``): under
``torch.func.vmap`` the Function's ``vmap`` rule sums a (B, T, 3, *w) stack
in one :func:`launch_members`, the members on the grid's y axis, each
member's rows the bits of a launch of its own
(``LAUNCHES["vertex_sum_members"]``); :func:`members_reference` is its twin.
The member gradients of kernels 1 and 2 sum each tile's interior vertices
inside their triangle pass and leave only the other rows to the vertex sum
(:func:`tile_sums`, kept once per CSR for both; :func:`tile_sums_reference`
is what the two passes add).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from membrane_solver_tpu_torch.device import shard as _shard
from membrane_solver_tpu_torch.device.state import CornerCSR
from membrane_solver_tpu_torch.kernels import _build, _launch

LAUNCHES = {"vertex_sum": 0, "vertex_sum_members": 0}
# the most members one launch takes (the grid's y extent)
MAX_MEMBERS = 65535
# corners per chunk: the kernel's kChunk (csrc/vertex_sum.cuh)
CHUNK = 8
# triangles per tile of the member gradients' in-tile sums (tile_sums): the
# block of csrc/frozen_tilt.cu (kThreads) and of csrc/tri_kernels.cu (kTile)
TILE = 128

KERNEL = _build.Source("vertex_sum")
SOURCE = KERNEL.path
HEADER = SOURCE.with_suffix(".cuh")

_lib = None
# the key of a CSR's passed launch check, kept on the CSR (check_csr)
_CHECKED = "_vertex_sum_checked"
# the key of a slot CSR's form without its spare row (summed_rows)
_SUMMED = "_vertex_sum_summed_rows"


def reference(corner_values: torch.Tensor, csr: CornerCSR, weight=None) -> torch.Tensor:
    """Plain twin: (T, 3, *w) corner rows summed into (N, *w) vertex rows in CSR order.

    Round k adds every vertex's k-th corner (zero past its last), so each
    vertex row is ``((0 + c_0) + c_1) + ...`` in slot order, as the kernel
    adds; ``x + 0`` is exact, so the padding changes no bit.  With ``weight``
    (T,), each corner row is first multiplied by its triangle's weight, as
    the weighted kernel does (``launch_weighted`` in ``csrc/vertex_sum.cuh``).
    """
    T = corner_values.shape[0]
    width = corner_values.shape[2:]
    flat = corner_values.reshape(3 * T, -1)
    starts = csr.offsets[:-1].long()
    degree = csr.offsets[1:].long() - starts
    slots = csr.slots.long()
    out = flat.new_zeros((csr.n_rows, flat.shape[1]))
    for k in range(csr.max_degree):
        live = degree > k
        slot = slots[torch.where(live, starts + k, 0)]
        rows = flat[slot]
        if weight is not None:
            rows = weight[slot // 3][:, None] * rows
        out = out + torch.where(live[:, None], rows, 0.0)
    return out.reshape((csr.n_rows,) + tuple(width))


@dataclasses.dataclass(frozen=True)
class TileSums:
    """Which vertex sums of a member gradient launch run inside the triangle pass (one topology).

    Shared by kernel 1's and kernel 2's member gradients (``frozen_tilt_members``,
    ``tri_surface_energy_members``), whose blocks both take ``TILE`` triangles.
    A vertex whose corners all lie in one ``TILE``-triangle tile is interior
    to it: the tile's block adds its corner gradients from shared memory in
    the corner CSR's order and writes the vertex rows.  The other (boundary)
    vertices' corners go through the corner scratch to the vertex sum, which
    skips interior rows.  ``interior`` (N,) uint8; ``tile_vertices`` (N,)
    int32: each tile's interior vertices in vertex order, tile by tile, then
    the boundary ones; ``tile_offsets`` (tiles + 2,) int32: tile x's at
    ``tile_offsets[x]:tile_offsets[x + 1]`` (the last range is the boundary
    vertices); ``corner_mask`` (T,) uint8: bit k set where corner k's vertex
    is a boundary vertex (its row goes to the scratch).
    """

    interior: torch.Tensor
    tile_vertices: torch.Tensor
    tile_offsets: torch.Tensor
    corner_mask: torch.Tensor

    @functools.cached_property
    def in_tile(self) -> bool:
        """Whether at least half the corners are interior vertices' (one host read, at first
        use): kernel 2's member gradient sums in its tiles only then.  A triangle order whose
        tiles hold few whole vertex fans (the square_to_circle lane's: 13% of corners, against
        kozlov L3's 77%) sends most corners to the scratch anyway, where the scattered
        boundary stores cost more than the in-tile sums save (PERF.md)."""
        mask = self.corner_mask.long()[:, None]
        boundary = int(((mask >> torch.arange(3, device=mask.device)) & 1).sum())
        return 2 * boundary <= 3 * mask.shape[0]


_TILE_SUMS = "_vertex_sum_tile_sums"  # the key of a CSR's TileSums in its __dict__


def tile_sums(csr: CornerCSR) -> TileSums:
    """The :class:`TileSums` of ``csr``'s topology, made at first use and kept on the CSR.

    Plain PyTorch on the CSR's device, fixed-size outputs, no host read.
    """
    kept = csr.__dict__.get(_TILE_SUMS)
    if kept is not None:
        return kept
    T, N = csr.rows.shape[0], csr.n_rows
    device = csr.slots.device
    tiles = -(-T // TILE)
    degree = (csr.offsets[1:] - csr.offsets[:-1]).long()
    vertex_of = torch.repeat_interleave(torch.arange(N, device=device), degree,
                                        output_size=csr.slots.shape[0])
    tile_of = csr.slots.long() // (3 * TILE)
    lo = torch.full((N,), tiles, dtype=torch.int64, device=device).scatter_reduce(
        0, vertex_of, tile_of, "amin")
    hi = torch.full((N,), -1, dtype=torch.int64, device=device).scatter_reduce(
        0, vertex_of, tile_of, "amax")
    interior = lo == hi  # a vertex with no corner is a boundary one (the vertex sum writes 0)
    bucket = torch.where(interior, lo, tiles)
    counts = torch.zeros(tiles + 1, dtype=torch.int64, device=device).scatter_add_(
        0, bucket, torch.ones_like(bucket))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    mask = ((~interior[csr.rows]).long() << torch.arange(3, device=device)).sum(1)
    kept = TileSums(interior=interior.to(torch.uint8),
                    tile_vertices=torch.argsort(bucket, stable=True).to(torch.int32),
                    tile_offsets=offsets.to(torch.int32), corner_mask=mask.to(torch.uint8))
    csr.__dict__[_TILE_SUMS] = kept
    return kept


def tile_sums_reference(corner_values: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    """What a member gradient launch's two passes add, in plain PyTorch: each tile's interior vertices
    from its own corner rows, then the boundary vertices from the corner rows the mask sends to
    the scratch (the rest left unread).  ``corner_values`` (T, 3, W); returns (N, W), which is
    ``vertex_sum.reference`` in bits (the same adds in the same order)."""
    ts = tile_sums(csr)
    T = corner_values.shape[0]
    flat = corner_values.reshape(3 * T, -1)
    sent = ((ts.corner_mask[:, None].long() >> torch.arange(3, device=flat.device)) & 1).bool()
    scratch = torch.where(sent.reshape(-1, 1), flat, torch.nan)
    out = flat.new_zeros((csr.n_rows, flat.shape[1]))
    offsets, slots = csr.offsets.tolist(), csr.slots.tolist()
    tiles = ts.tile_offsets.shape[0] - 2
    bounds = ts.tile_offsets.tolist()
    order = ts.tile_vertices.tolist()
    for x in range(tiles + 1):
        source = flat if x < tiles else scratch
        for v in order[bounds[x]:bounds[x + 1]]:
            acc = flat.new_zeros(flat.shape[1])
            for s in slots[offsets[v]:offsets[v + 1]]:
                if x < tiles and s // (3 * TILE) != x:
                    raise AssertionError(f"interior vertex {v} of tile {x} has slot {s}")
                acc = acc + source[s]
            out[v] = acc
    return out.reshape((csr.n_rows,) + tuple(corner_values.shape[2:]))


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    (lib,) = _build.build(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vertex_sum_rows.argtypes = [i32, i32, ptr, ptr, ptr, ptr, i32, ptr]
    lib.vertex_sum_rows.restype = i32
    lib.vertex_sum_rows_members.argtypes = [i32, i32, ptr, ptr, ptr, ptr, i32, ctypes.c_int64,
                                            i32, ptr]
    lib.vertex_sum_rows_members.restype = i32
    _lib = lib
    return lib


def check_csr(csr: CornerCSR, like: torch.Tensor, n_triangles: int) -> None:
    """The CSR on ``like``'s device, int32, contiguous, with 3 * ``n_triangles`` slots.

    A CSR is frozen and built once per topology, so a passed check is kept
    on it, keyed by the device and the slot count: later launches on the
    same device and triangle count compare those two alone.
    """
    key = (like.device, 3 * n_triangles)
    if csr.__dict__.get(_CHECKED) == key:
        return
    for name, x, shape in (("offsets", csr.offsets, (csr.n_rows + 1,)),
                           ("slots", csr.slots, (3 * n_triangles,))):
        if x.device != like.device:
            raise ValueError(f"csr.{name} must lie on {like.device}, got {x.device}")
        if x.dtype != torch.int32 or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"csr.{name} must be contiguous int32 of shape {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
    csr.__dict__[_CHECKED] = key


def count(key: str, like: torch.Tensor, csr: CornerCSR) -> None:
    """One launch of the kernel as ``key`` over ``csr`` on ``like``'s card, from this module or
    from an entry point that launches it inside its own call (``kernels/_launch.count``)."""
    _launch.count(LAUNCHES, "vertex_sum", key, like, csr)


def launch(corner_values: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    """(N, *w) vertex rows from the kernel; ``corner_values`` (T, 3) or (T, 3, 3), on the card."""
    if not corner_values.is_cuda:
        raise ValueError(f"the vertex_sum launch takes CUDA tensors, got {corner_values.device}")
    if corner_values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vertex_sum takes float32 or float64, got {corner_values.dtype}")
    if corner_values.dim() not in (2, 3) or corner_values.shape[1] != 3 or (
            corner_values.dim() == 3 and corner_values.shape[2] != 3):
        raise ValueError(f"corner values must be (T, 3) or (T, 3, 3), got "
                         f"{tuple(corner_values.shape)}")
    if not corner_values.is_contiguous():
        raise ValueError("corner values must be contiguous")
    check_csr(csr, corner_values, corner_values.shape[0])
    width = 3 if corner_values.dim() == 3 else 1
    lib = build()
    out = corner_values.new_empty((csr.n_rows,) + tuple(corner_values.shape[2:]))
    code = _launch.call(
        corner_values, lib.vertex_sum_rows,
        int(corner_values.dtype == torch.float64), width, csr.offsets.data_ptr(),
        csr.slots.data_ptr(), corner_values.data_ptr(), out.data_ptr(), csr.n_rows,
    )
    if code != 0:
        raise RuntimeError(f"vertex_sum_rows launch failed: cudaError {code}")
    count("vertex_sum", corner_values, csr)
    return out


def batched(x: torch.Tensor) -> bool:
    """True for a tensor inside ``torch.func.vmap`` that carries the member axis.

    The sweep (``parallel/sweep``) maps the energy over its members with
    ``vmap``; the entry points then route through their autograd Functions,
    whose ``vmap`` rules launch the member-axis kernels.
    """
    return torch._C._functorch.is_batchedtensor(x)


def members_reference(corner_values: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    """Plain twin of :func:`launch_members`: :func:`reference` for each member of (B, T, 3, *w)."""
    return torch.stack([reference(c, csr) for c in corner_values])


def launch_members(corner_values: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    """(B, N, *w) vertex rows of (B, T, 3, *w) corner rows: one launch, the members on its y axis.

    Member m's rows are the bits :func:`launch` gives for member m alone.
    """
    if not corner_values.is_cuda:
        raise ValueError(f"the vertex_sum launch takes CUDA tensors, got {corner_values.device}")
    if corner_values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vertex_sum takes float32 or float64, got {corner_values.dtype}")
    if corner_values.dim() not in (3, 4) or corner_values.shape[2] != 3 or (
            corner_values.dim() == 4 and corner_values.shape[3] != 3):
        raise ValueError(f"member corner values must be (B, T, 3) or (B, T, 3, 3), got "
                         f"{tuple(corner_values.shape)}")
    if not corner_values.is_contiguous():
        raise ValueError("corner values must be contiguous")
    members = corner_values.shape[0]
    if not 1 <= members <= MAX_MEMBERS:
        raise ValueError(f"{members} members; the launch takes 1 to {MAX_MEMBERS}")
    check_csr(csr, corner_values, corner_values.shape[1])
    width = 3 if corner_values.dim() == 4 else 1
    lib = build()
    out = corner_values.new_empty((members, csr.n_rows) + tuple(corner_values.shape[3:]))
    code = _launch.call(
        corner_values, lib.vertex_sum_rows_members,
        int(corner_values.dtype == torch.float64), width, csr.offsets.data_ptr(),
        csr.slots.data_ptr(), corner_values.data_ptr(), out.data_ptr(), csr.n_rows,
        3 * corner_values.shape[1], members,
    )
    if code != 0:
        raise RuntimeError(f"vertex_sum_rows_members launch failed: cudaError {code}")
    count("vertex_sum_members", corner_values, csr)
    return out


def _members_sum(corner_values: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    if corner_values.is_cuda:
        return launch_members(corner_values.contiguous(), csr)
    return members_reference(corner_values, csr)


class _MemberVertexSum(torch.autograd.Function):
    """:class:`_VertexSum` over a leading member axis (its ``vmap`` rule's launch)."""

    @staticmethod
    def forward(ctx, corner_values, csr):
        ctx.csr = csr
        return _members_sum(corner_values, csr)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.csr.rows], None


class _VertexSum(torch.autograd.Function):
    @staticmethod
    def forward(corner_values, csr):
        if corner_values.is_cuda:
            return launch(corner_values.contiguous(), csr)
        return reference(corner_values, csr)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.csr = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.csr.rows], None

    @staticmethod
    def vmap(info, in_dims, corner_values, csr):
        return _MemberVertexSum.apply(corner_values.movedim(in_dims[0], 0), csr), 0


def vertex_sum(corner_values: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    """(T, 3, *w) corner rows summed into (N, *w) vertex rows in CSR order, differentiable.

    The kernel on the card (w is 1 or 3), :func:`reference` on the CPU; the
    backward gathers the vertex upstream to the corners through ``csr.rows``.
    A call that autograd does not follow (the projections, the line search's
    energy-only trials) skips the Function and its host cost.  Under
    ``torch.func.vmap`` (:func:`batched`) every call takes the Function,
    whose ``vmap`` rule sums all members in one :func:`launch_members`.  A ``csr`` that
    carries a shard plan (``device/shard``) sums each shard's corner rows on its device and
    reduces the shards' rows in shard order.
    """
    plan = _shard.plan_of(csr, corner_values, corner_values)
    if plan is not None:
        return plan.reduce_rows(plan.map(lambda s, c: vertex_sum(c, s.csr),
                                         tri=(corner_values,)))
    if batched(corner_values) or (torch.is_grad_enabled() and corner_values.requires_grad):
        return _VertexSum.apply(corner_values, csr)
    if corner_values.is_cuda:
        return launch(corner_values.contiguous(), csr)
    return reference(corner_values, csr)


class _MemberCornerGather(torch.autograd.Function):
    """:class:`_CornerGather` over a leading member axis (its ``vmap`` rule)."""

    @staticmethod
    def forward(ctx, vertex_values, csr):
        ctx.csr = csr
        return vertex_values[:, csr.rows]

    @staticmethod
    def backward(ctx, grad):
        return _MemberVertexSum.apply(grad, ctx.csr), None


class _CornerGather(torch.autograd.Function):
    @staticmethod
    def forward(vertex_values, csr):
        return vertex_values[csr.rows]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.csr = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return vertex_sum(grad, ctx.csr), None

    @staticmethod
    def vmap(info, in_dims, vertex_values, csr):
        return _MemberCornerGather.apply(vertex_values.movedim(in_dims[0], 0), csr), 0


def corner_gather(vertex_values: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    """(N, *w) vertex rows gathered to the (T, 3, *w) triangle corners, differentiable.

    The backward sums the corner upstream into the vertices through
    :func:`vertex_sum` (an indexing backward would add a vertex's repeated
    corners with atomics on the card, and in another order under
    ``torch.func.vmap`` than in a single call).
    """
    if batched(vertex_values) or (torch.is_grad_enabled() and vertex_values.requires_grad):
        return _CornerGather.apply(vertex_values, csr)
    return vertex_values[csr.rows]


def summed_rows(csr: CornerCSR) -> CornerCSR:
    """``csr`` with its spare last row emptied, built at first use and kept on ``csr``.

    :func:`row_sum` drops that row, which holds every padding slot and every
    slot aimed at it (a kept CSR's dropped entries): its launch writes the
    row as zero after one read of its offsets instead of summing them.  The
    slots and ``rows`` stay, so the backward still gathers every slot.
    """
    kept = csr.__dict__.get(_SUMMED)
    if kept is None:
        offsets = torch.cat([csr.offsets[:-1], csr.offsets[-2:-1]])
        kept = dataclasses.replace(csr, offsets=offsets)
        csr.__dict__[_SUMMED] = kept
    return kept


def row_sum(values: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    """(K, *w) slot values summed into ``csr.n_rows - 1`` rows in a fixed order.

    ``csr`` is the ``state.slot_csr`` of the K target rows; the slots it pads
    and any slot aimed at the spare last row are dropped with that row,
    which is not summed (:func:`summed_rows`).
    """
    n_slots = csr.slots.shape[0]
    pad = values.new_zeros((n_slots - values.shape[0],) + tuple(values.shape[1:]))
    corner = torch.cat([values, pad]).reshape((n_slots // 3, 3) + tuple(values.shape[1:]))
    return vertex_sum(corner, summed_rows(csr))[:-1]
