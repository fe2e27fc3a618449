"""Interactive command-line entry point.

Counterpart of ``membrane_solver_tpu/cli.py`` (reference ``main.py``):
argument parsing, mesh load with interactive orientation repair,
instruction execution, Evolver-style REPL with readline history/completion,
save-on-exit.  Run as ``python -m membrane_solver_tpu_torch``.

The device and dtype are flags: the card by default (``device="cuda"``,
which raises without one: there is no fallback), ``--cpu`` for the CPU,
``--f32`` for float32 (float64 otherwise).  Not ported: the JAX package's
backend probe (its purpose is a CPU fallback), the capacity plan (the port
compiles at exact sizes, with no padding) and its x64 environment switch.
``--viz``, ``--viz-save`` and the ``s`` command render with matplotlib
(``visualization/``), their face values on the context's device.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

import torch

from membrane_solver_tpu_torch.commands import CommandContext, execute_command_line
from membrane_solver_tpu_torch.commands.registry import COMMAND_REGISTRY
from membrane_solver_tpu_torch.core.exceptions import BodyOrientationError
from membrane_solver_tpu_torch.geometry.io_readers import load_data, parse_geometry
from membrane_solver_tpu_torch.geometry.io_writers import save_geometry
from membrane_solver_tpu_torch.runtime.minimizer import Minimizer
from membrane_solver_tpu_torch.runtime.steppers import make_stepper

logger = logging.getLogger("membrane_solver_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="membrane_solver_tpu_torch",
        description="Surface-Evolver-style membrane energy minimizer on PyTorch and CUDA",
    )
    p.add_argument("-i", "--input", required=True, help="input mesh (JSON/YAML)")
    p.add_argument("-o", "--output", help="save the final mesh here on exit")
    p.add_argument("--non-interactive", action="store_true", help="skip the REPL")
    p.add_argument("-q", "--quiet", action="store_true", help="suppress per-step output")
    p.add_argument("--debug", action="store_true", help="debug logging")
    p.add_argument("--debugger", action="store_true",
                   help="drop into pdb post-mortem when an instruction fails")
    p.add_argument("--log", nargs="?", const="", help="log to a file (default: next to input)")
    p.add_argument("--stepper", default="gd", choices=["gd", "cg", "bfgs"])
    p.add_argument("--step-size", type=float, default=None)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--volume-mode", choices=["penalty", "lagrange"], default=None)
    p.add_argument("--line-tension", type=float, default=None)
    p.add_argument(
        "--line-tension-edges",
        help="comma-separated edge ids to tag with the line_tension energy",
    )
    p.add_argument("--properties", action="store_true", help="print area/volume/Rg and exit")
    p.add_argument("--radius-of-gyration", action="store_true")
    p.add_argument("--viz", action="store_true", help="show the final mesh")
    p.add_argument("--viz-save", help="save a rendering to this path")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    p.add_argument("--f32", action="store_true", help="float32 compute (float64 otherwise)")
    p.add_argument("instructions", nargs="*", help="commands to run before the file's own")
    return p


def _configure_logging(args) -> None:
    level = logging.DEBUG if args.debug else logging.INFO
    handlers = [logging.StreamHandler()] if not args.quiet or args.debug else []
    if args.log is not None:
        path = args.log or str(Path(args.input).with_suffix(".log"))
        handlers.append(logging.FileHandler(path))
    logging.basicConfig(level=level, handlers=handlers or None, force=True)


def load_mesh_interactive(path: str, interactive: bool):
    """Parse the mesh; offer to repair inverted bodies when interactive."""
    data = load_data(path)
    mesh = parse_geometry(data)
    try:
        mesh.validate_body_orientation()
    except BodyOrientationError as exc:
        if interactive and sys.stdin.isatty():
            answer = input(f"{exc}\nFlip the body's facets and continue? [y/N] ")
            if answer.strip().lower() in {"y", "yes"}:
                mesh.validate_body_orientation(repair=True)
                fixed_path = Path(path).with_suffix(".oriented.json")
                save_geometry(mesh, fixed_path)
                print(f"Repaired orientation saved to {fixed_path}")
            else:
                raise
        else:
            mesh.validate_body_orientation(repair=True)
            logger.warning("Repaired inverted body orientation automatically.")
    return mesh


def make_context(args, mesh) -> CommandContext:
    """The command context of a parsed command line: parameters, Minimizer, stepper.

    Applies ``--volume-mode`` and the line-tension flags to the mesh, then
    builds the Minimizer on the device and dtype the flags name.
    """
    gp = mesh.global_parameters
    if args.volume_mode:
        gp.set("volume_constraint_mode", args.volume_mode)
        gp.set("volume_projection_during_minimization", args.volume_mode == "penalty")
    if args.line_tension is not None:
        gp.set("line_tension", args.line_tension)
    if args.line_tension_edges:
        for eid in args.line_tension_edges.split(","):
            edge = mesh.edges[int(eid)]
            energy = edge.options.setdefault("energy", [])
            if "line_tension" not in energy:
                energy.append("line_tension")
        if "line_tension" not in mesh.energy_modules:
            mesh.energy_modules.append("line_tension")

    minimizer = Minimizer(
        mesh,
        stepper=make_stepper(args.stepper),
        step_size=args.step_size or float(gp.get("step_size", 1e-3)),
        tol=args.tol,
        quiet=args.quiet,
        device="cpu" if args.cpu else "cuda",
        dtype=torch.float32 if args.f32 else torch.float64,
    )
    return CommandContext(mesh=mesh, minimizer=minimizer, stepper=minimizer.stepper)


def repl(ctx: CommandContext) -> None:
    try:
        import readline

        histfile = os.environ.get(
            "MEMBRANE_HISTORY_FILE", str(Path.home() / ".membrane_solver_tpu_torch_history")
        )
        try:
            readline.read_history_file(histfile)
        except OSError:
            pass
        readline.set_history_length(int(os.environ.get("MEMBRANE_HISTORY_LENGTH", "500")))

        def completer(text, state):
            from membrane_solver_tpu_torch.commands.completion import (
                command_line_completions,
            )

            matches = command_line_completions(
                text=text,
                line_buffer=readline.get_line_buffer(),
                command_names=COMMAND_REGISTRY,
                macro_names=ctx.mesh.macros,
            )
            return matches[state] if state < len(matches) else None

        readline.set_completer(completer)
        readline.parse_and_bind("tab: complete")
    except ImportError:
        readline = None
        histfile = None

    ctx.history = []
    print("Interactive mode. Type commands (g5, r, u, V2, energy, help, q to quit).")
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            print()
            break
        try:
            execute_command_line(ctx, line)
            ctx.sync_mesh()
        except SystemExit:
            break
        except Exception as exc:  # keep the REPL alive on command errors
            logger.error("Command failed: %s", exc)
    if readline is not None and histfile:
        try:
            readline.write_history_file(histfile)
        except OSError:
            pass


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _configure_logging(args)
    mesh = load_mesh_interactive(args.input, interactive=not args.non_interactive)
    ctx = make_context(args, mesh)

    if args.properties or args.radius_of_gyration:
        execute_command_line(ctx, "properties")
        return 0

    try:
        for line in args.instructions:
            execute_command_line(ctx, line)
            ctx.sync_mesh()
        for line in mesh.instructions:
            execute_command_line(ctx, line)
            ctx.sync_mesh()
    except Exception:
        if args.debugger:
            # post-mortem debugging of a failed instruction (reference
            # main.py --debugger)
            import pdb
            import traceback

            traceback.print_exc()
            pdb.post_mortem()
            return 1
        raise

    if args.viz or args.viz_save:
        from membrane_solver_tpu_torch.visualization.plot_core import plot_geometry

        plot_geometry(ctx.mesh, show=args.viz, save_path=args.viz_save,
                      device=ctx.minimizer.device, dtype=ctx.minimizer.dtype)

    if not args.non_interactive:
        repl(ctx)

    if args.output:
        save_geometry(ctx.mesh, args.output)
        print(f"Saved mesh to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
