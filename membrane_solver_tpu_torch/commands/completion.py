"""Interactive CLI tab-completion helpers.

Copy of ``membrane_solver_tpu/commands/completion.py`` (host code); only the
import paths differ.

Parity: reference ``commands/completion.py`` — conservative completion
that only completes the FIRST token of the active `;`-separated segment
(never argument positions), plus subcommand completion for ``energy``.
Pure functions so the behavior is testable without a terminal
(tests/test_cli_completion.py).
"""

from __future__ import annotations

from typing import Iterable, List

ENERGY_SUBCOMMANDS = (
    "breakdown",
    "details",
    "detail",
    "stats",
    "curvature",
    "total",
    "sum",
    "ref",
    "reference",
)


def command_name_completions(
    *,
    text: str,
    line_buffer: str,
    command_names: Iterable[str],
    macro_names: Iterable[str] = (),
) -> List[str]:
    """Candidates for the current command NAME.

    Compound lines split on ``;`` and only the last segment is considered;
    a segment that already contains a space is in argument position and
    gets no command-name completions.
    """
    segment = (line_buffer or "").split(";")[-1].lstrip()
    if segment and " " in segment:
        return []
    want = (text or "").strip() or segment
    names = {str(n) for n in command_names} | {str(n) for n in macro_names}
    return sorted(n for n in names if n.startswith(want))


def command_line_completions(
    *,
    text: str,
    line_buffer: str,
    command_names: Iterable[str],
    macro_names: Iterable[str] = (),
) -> List[str]:
    """Candidates for the current command LINE (names + energy subcommands)."""
    segment = (line_buffer or "").split(";")[-1].lstrip()
    tokens = segment.split()
    if not tokens or (len(tokens) == 1 and not segment.endswith(" ")):
        return command_name_completions(
            text=text,
            line_buffer=line_buffer,
            command_names=command_names,
            macro_names=macro_names,
        )
    if tokens[0].lower() != "energy":
        return []
    want = (text or "").strip()
    if not want and not segment.endswith(" "):
        want = tokens[-1]
    return sorted(n for n in ENERGY_SUBCOMMANDS if not want or n.startswith(want))
