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
