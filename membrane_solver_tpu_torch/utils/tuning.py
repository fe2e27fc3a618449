"""Device-dependent execution switches.

Counterpart of ``membrane_solver_tpu/utils/tuning.py``.  Each switch picks
between two execution strategies that give the same results, bit for bit
per candidate; only the scheduling changes.  On the CPU the sequential
forms stay (fewer energy evaluations, the reference's trial loop); on an
accelerator the batched forms run, as the JAX package runs them on any
backend other than the CPU.
"""

from __future__ import annotations

import os

import torch

# the spellings of MEMBRANE_SOLVER_BATCHED_LS that turn the batched form off
_OFF = frozenset({"0", "false", "no"})


def batched_line_search(device) -> bool:
    """Evaluate a backtracking search's candidates as one mapped batch, for state on ``device``.

    A backtracking search's candidate steps are known before it starts (a
    fixed halving or beta chain), so its decision (the first candidate whose
    trial passes) can be taken from one batched evaluation: candidate 0
    alone, then, when it is rejected, every other candidate in one
    ``torch.func.vmap``.  The decisions and the accepted state are the
    sequential loop's; on a card the chain of dependent trials, each ending
    in a host read, becomes two host reads.  ``MEMBRANE_SOLVER_BATCHED_LS``
    overrides (any value but ``0``, ``false`` or ``no`` turns it on);
    otherwise it is on for every device but the CPU.
    """
    env = os.environ.get("MEMBRANE_SOLVER_BATCHED_LS")
    if env is not None:
        return env not in _OFF
    return torch.device(device).type != "cpu"
