"""Command-line execution with macro expansion.

Copy of ``membrane_solver_tpu/commands/executor.py`` (host code); only the
import paths differ.

Parity: reference ``commands/executor.py`` (semicolon compound lines, macro
expansion with depth/recursion guards, history recording).
"""

from __future__ import annotations

import logging
from typing import Iterable, Tuple

from membrane_solver_tpu_torch.commands.registry import get_command

logger = logging.getLogger("membrane_solver_tpu_torch")

MAX_MACRO_DEPTH = 20


def execute_command_line(
    context,
    line: str,
    *,
    get_command_fn=get_command,
    macro_stack: Tuple[str, ...] = (),
    max_macro_depth: int = MAX_MACRO_DEPTH,
) -> None:
    line = (line or "").strip()
    if not line:
        return

    if ";" in line:
        for part in (p.strip() for p in line.split(";")):
            if part:
                execute_command_line(
                    context,
                    part,
                    get_command_fn=get_command_fn,
                    macro_stack=macro_stack,
                    max_macro_depth=max_macro_depth,
                )
        return

    parts = line.split()
    cmd_name, cmd_args = parts[0], parts[1:]

    command, extra_args = get_command_fn(cmd_name)
    if command is not None:
        command.execute(context, extra_args + cmd_args)
        history = getattr(context, "history", None)
        if history is not None:
            history.append(line)
        return

    macros = getattr(context.mesh, "macros", {}) or {}
    if cmd_name in macros:
        if cmd_args:
            logger.warning("Macro %r takes no arguments; ignoring %s", cmd_name, cmd_args)
        if len(macro_stack) >= max_macro_depth:
            raise RuntimeError(
                "Macro expansion exceeded max depth "
                f"({max_macro_depth}): {' -> '.join(macro_stack + (cmd_name,))}"
            )
        if cmd_name in macro_stack:
            raise RuntimeError(
                f"Recursive macro call detected: {' -> '.join(macro_stack + (cmd_name,))}"
            )
        for macro_line in _macro_lines(macros[cmd_name]):
            execute_command_line(
                context,
                macro_line,
                get_command_fn=get_command_fn,
                macro_stack=macro_stack + (cmd_name,),
                max_macro_depth=max_macro_depth,
            )
        return

    logger.warning("Unknown instruction: %s", cmd_name)


def _macro_lines(lines: Iterable[str]) -> Iterable[str]:
    for line in lines:
        line = (line or "").strip()
        if line:
            yield line
