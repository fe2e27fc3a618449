"""Execution context shared by commands.

Copy of ``membrane_solver_tpu/commands/context.py`` (host code); only the
import paths differ.

Parity: reference ``commands/context.py`` (CommandContext dataclass).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from membrane_solver_tpu_torch.geometry.mesh import Mesh
from membrane_solver_tpu_torch.runtime.minimizer import Minimizer


@dataclass
class CommandContext:
    mesh: Mesh
    minimizer: Minimizer
    stepper: Any = None
    extras: Dict[str, Any] = field(default_factory=dict)
    live_vis: bool = False
    reference_energy: Optional[Dict[str, float]] = None

    def sync_mesh(self) -> None:
        """Adopt the minimizer's (possibly replaced) mesh."""
        self.mesh = self.minimizer.mesh
        self.stepper = self.minimizer.stepper
