"""Sums in an order that does not depend on a batch: the member path's reductions.

A member of the parameter sweep (``parallel/member_block``) runs its
modules under ``torch.func.vmap``, where ``torch.sum(x)`` of one member's
(n,) array becomes a reduction over an inner axis of a (B, n) batch.
PyTorch picks that reduction's order from the shapes (on the card the
split over blocks and threads, on the CPU the split over threads), so a
member's sum need not be the bits of its own call's.  :func:`tree_sum`
adds in a fixed halving tree of elementwise additions instead: the
operand is zero-padded to a power of two along the summed axis and its
two halves are added until one row is left.  Every addition is
elementwise, which ``vmap`` keeps per member, so member m's sum is the
bits of the single call on member m, on any device and at any B.  Its
backward hands the upstream gradient to every entry unchanged, as the
backward of ``torch.sum`` does.

Where a module must keep the order of its own single call (a sum whose
single-call bits a lane or a test holds), :func:`member_sum` and
:func:`per_member` leave that call as it is and run it once per member
under ``vmap``: each member's operands are copied into a fresh contiguous
buffer (the layout and alignment a single call's operand has), so member
m's value is the bits of the single call on member m, at any B.  Dense
products and solves go the same way, since PyTorch picks a batched
product's or factorization's algorithm by the batch count.
"""

from __future__ import annotations

import torch


def tree_sum(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """Sum of ``x`` over every entry (``dim`` None) or along ``dim``, in a fixed halving tree."""
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    x = torch.movedim(x, dim, 0)
    n = x.shape[0]
    if n == 0:
        return x.new_zeros(x.shape[1:])
    size = 1 << (n - 1).bit_length()
    if size != n:
        x = torch.cat([x, x.new_zeros((size - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def _batched(x) -> bool:
    return isinstance(x, torch.Tensor) and torch._C._functorch.is_batchedtensor(x)


def own(x: torch.Tensor) -> torch.Tensor:
    """A member's operand as a single call's: a fresh contiguous buffer."""
    return x.clone(memory_format=torch.contiguous_format)


def each_member(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn`` on each member's operands of (B, ...) ``args``, stacked: one call per member on
    its own contiguous copies, as a one-member batch makes it (a batched product picks its
    algorithm by the member count, and a member's slice of the batch its alignment by its
    index)."""
    return torch.stack([fn(*(own(a[m]) for a in args)) for m in range(args[0].shape[0])])


def _sum(x: torch.Tensor, dim):
    return torch.sum(x) if dim is None else torch.sum(x, dim)


def _unsum(grad: torch.Tensor, shape, dim, lead: int) -> torch.Tensor:
    """The backward of :func:`_sum` over ``shape`` (``lead`` leading axes kept)."""
    if dim is None:
        grad = grad.reshape(tuple(grad.shape[:lead]) + (1,) * (len(shape) - lead))
    else:
        grad = grad.unsqueeze(lead + dim % (len(shape) - lead))
    return grad.expand(shape)


class _MembersSum(torch.autograd.Function):
    """:class:`_MemberSum` over a leading member axis (its ``vmap`` rule): one call per member."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.shape, ctx.dim = x.shape, dim
        return torch.stack([_sum(own(x[m]), dim) for m in range(x.shape[0])])

    @staticmethod
    def backward(ctx, grad):
        return _unsum(grad, ctx.shape, ctx.dim, 1), None


class _MemberSum(torch.autograd.Function):
    @staticmethod
    def forward(x, dim):
        return _sum(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shape, ctx.dim = inputs[0].shape, inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _unsum(grad, ctx.shape, ctx.dim, 0), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        return _MembersSum.apply(x.movedim(in_dims[0], 0), dim), 0


def member_sum(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """``torch.sum(x)`` (or along ``dim``), differentiable: the single call itself, and under
    ``torch.func.vmap`` that call once per member on its own operand."""
    if _batched(x):
        return _MemberSum.apply(x, dim)
    return _sum(x, dim)


class _PerMember(torch.autograd.Function):
    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, fn, *args):
        return each_member(fn, *(a.movedim(d, 0) if d is not None
                                 else a.expand(info.batch_size, *a.shape)
                                 for a, d in zip(args, in_dims[1:]))), 0


def per_member(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)`` (one tensor out, not differentiated): the single call itself, and under
    ``torch.func.vmap`` one call per member on its own operands (a dense product or solve)."""
    if any(_batched(a) for a in args):
        return _PerMember.apply(fn, *args)
    return fn(*args)
