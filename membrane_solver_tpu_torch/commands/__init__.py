"""The Evolver-style command layer: counterpart of ``membrane_solver_tpu/commands``."""

from membrane_solver_tpu_torch.commands.context import CommandContext
from membrane_solver_tpu_torch.commands.executor import execute_command_line
from membrane_solver_tpu_torch.commands.registry import COMMAND_REGISTRY, get_command

__all__ = ["CommandContext", "execute_command_line", "COMMAND_REGISTRY", "get_command"]
