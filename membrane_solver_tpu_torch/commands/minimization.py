"""Minimization commands: g/gN, stepper switches, hessian, live vis toggles.

Counterpart of ``membrane_solver_tpu/commands/minimization.py``: the same
host code; live visualization redraws on the minimizer's device.

Parity: reference ``commands/minimization.py``.
"""

from __future__ import annotations

import logging

from membrane_solver_tpu_torch.commands.base import Command
from membrane_solver_tpu_torch.runtime.steppers import BFGS, ConjugateGradient, GradientDescent

logger = logging.getLogger("membrane_solver_tpu_torch")


class GoCommand(Command):
    help_text = "g[N] — run N minimization steps (default 1)"

    def execute(self, context, args):
        n_steps = 1
        if args and args[0].isdigit():
            n_steps = int(args[0])
        callback = None
        if getattr(context.minimizer, "live_vis", False):
            from membrane_solver_tpu_torch.visualization.plot_live import update_live_vis

            state = getattr(context.minimizer, "live_vis_state", None)

            def callback(mesh, i):
                nonlocal state
                state = update_live_vis(mesh, state=state, title=f"Step {i}",
                                        device=context.minimizer.device,
                                        dtype=context.minimizer.dtype)
                context.minimizer.live_vis_state = state

        result = context.minimizer.minimize(n_steps=n_steps, callback=callback)
        context.mesh = result["mesh"]
        logger.info("Minimization complete. Final energy: %s", result["energy"])
        # post-run topology hazard scan (reference commands/minimization.py:54-58)
        from membrane_solver_tpu_torch.runtime.topology_guards import (
            detect_vertex_edge_collisions,
        )

        collisions = detect_vertex_edge_collisions(context.mesh)
        if collisions:
            logger.warning(
                "TOPOLOGY WARNING: %d vertex-edge collisions detected!", len(collisions)
            )


class SetStepperCommand(Command):
    def __init__(self, stepper_type: str):
        self.stepper_type = stepper_type

    def execute(self, context, args):
        stepper = {"cg": ConjugateGradient, "gd": GradientDescent, "bfgs": BFGS}[
            self.stepper_type
        ]()
        logger.info("Switching to %s stepper.", type(stepper).__name__)
        context.stepper = stepper
        context.minimizer.stepper = stepper
        context.minimizer._stepper_state = None  # reset device stepper memory


class HessianCommand(Command):
    """One-off BFGS steps without switching the active stepper."""

    def execute(self, context, args):
        steps = 1
        if args and args[0].isdigit():
            steps = max(1, int(args[0]))
        saved = context.minimizer.stepper
        saved_state = context.minimizer._stepper_state
        try:
            context.minimizer.stepper = BFGS()
            context.minimizer._stepper_state = None
            context.minimizer.minimize(n_steps=steps)
        finally:
            context.minimizer.stepper = saved
            context.minimizer._stepper_state = saved_state
        context.mesh = context.minimizer.mesh


class LiveVisCommand(Command):
    def execute(self, context, args):
        minim = context.minimizer
        if args and args[0] in {"off", "0", "false"}:
            minim.live_vis = False
            logger.info("Live visualization disabled.")
            return
        minim.live_vis = True
        minim.live_vis_color_by = args[0] if args else None
        logger.info("Live visualization enabled.")


class ShowEdgesCommand(Command):
    def execute(self, context, args):
        show = not (args and args[0] in {"off", "0", "false"})
        context.minimizer.live_vis_show_edges = show
