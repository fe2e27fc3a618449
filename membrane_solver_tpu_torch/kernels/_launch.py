"""The host side every ctypes launch shares: its card, its stream and its count.

A kernel launches into the CUDA context of the calling thread's current
device, so :func:`call` makes the tensor's card current around the ctypes
call and passes that card's current stream (the raw handle): a tensor on
``cuda:1`` launches on ``cuda:1`` whatever card the caller had current.
One library (``kernels/_build``) serves every card.

:func:`count` adds one to a module's ``LAUNCHES`` entry and to the card's
own counts (:func:`launches_on`), under a lock, so launches from several
host threads (the placed sweep's groups, ``parallel/sweep``) and from the
autograd engine's device threads are all counted.  A launch that names a
corner CSR also counts in that CSR's tally when it has one
(:func:`keep_tally`): the vertex-sharded evaluation (``parallel/tensor``)
counts each shard's launches, forward and backward, that way.
"""

from __future__ import annotations

import threading

import torch

_LOCK = threading.Lock()
# card index -> {"<module>.<key>": launches}
_PER_CARD: dict = {}
# the key of a CSR's tally in its __dict__ (keep_tally)
_TALLY = "_launch_tally"


def call(like: torch.Tensor, fn, *args) -> int:
    """``fn(*args, stream)`` with ``like``'s card current; ``stream`` is that card's current
    stream.  Returns what ``fn`` returns (the launch's cudaError code)."""
    index = like.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if torch._C._cuda_getDevice() == index:
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def count(counters: dict, module: str, key: str, like: torch.Tensor, csr=None) -> None:
    """One launch of ``module``'s ``key`` on ``like``'s card, with ``csr`` (if any) the corner
    CSR it summed over."""
    name = f"{module}.{key}"
    tally = None if csr is None else csr.__dict__.get(_TALLY)
    with _LOCK:
        counters[key] += 1
        card = _PER_CARD.setdefault(like.get_device(), {})
        card[name] = card.get(name, 0) + 1
        if tally is not None:
            tally[name] = tally.get(name, 0) + 1


def launches_on(index: int) -> dict:
    """A copy of the launches on card ``index`` so far, by ``"<module>.<key>"``."""
    with _LOCK:
        return dict(_PER_CARD.get(index, {}))


def keep_tally(csr, into: dict) -> None:
    """From now on, every launch that names ``csr`` also counts in ``into``."""
    csr.__dict__[_TALLY] = into
