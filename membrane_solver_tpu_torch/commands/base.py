"""Command base class (parity: reference commands/base.py).

Copy of ``membrane_solver_tpu/commands/base.py`` (host code); only the
import paths differ.
"""

from __future__ import annotations


class Command:
    """A named REPL/instruction command."""

    help_text: str = ""

    def execute(self, context, args) -> None:  # pragma: no cover - interface
        raise NotImplementedError
