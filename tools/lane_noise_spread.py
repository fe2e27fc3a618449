#!/usr/bin/env python3
"""How far a meshgen lane's own JAX run moves under one-ulp noise.

Runs a builder's recipe through the JAX package's command layer on the CPU
at float64, with every ``gN`` expanded into N ``g1`` commands, once as
built and once per seed with one-ulp noise on every coordinate of every
free vertex (each coordinate moved to the next float up, down, or left, at
random) before the first command.  Prints, as one JSON object, the clean
run's per-command energies and step sizes, and per command the largest
relative energy spread over the seeds; with ``-o``, also a JSON file of
them by lane, which the port's lane test (``tests/test_torch_lanes.py``)
reads to hold the port to twice these spreads.

Usage::

    python tools/lane_noise_spread.py catenoid spherical_cap [--seeds 4] \
        [-o tests/fixtures/torch_port/lane_noise_spread.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def expanded(instructions) -> list:
    """The recipe with every ``gN`` replaced by N ``g1`` commands."""
    out = []
    for cmd in instructions:
        if cmd[0] == "g" and cmd[1:].isdigit():
            out += ["g1"] * int(cmd[1:])
        else:
            out.append(cmd)
    return out


def run(name: str, seed: int | None) -> list:
    """(command, energy, step size) after each command of the expanded recipe."""
    import membrane_solver_tpu as pkg
    from membrane_solver_tpu.commands import CommandContext, execute_command_line
    from membrane_solver_tpu.meshgen import build
    from membrane_solver_tpu.runtime.steppers import make_stepper

    data = build(name)
    mesh = pkg.parse_geometry(json.loads(json.dumps(data)))
    if seed is not None:
        rng = np.random.default_rng(seed)
        for vid in sorted(mesh.vertices):
            v = mesh.vertices[vid]
            if v.fixed:
                continue
            step = rng.integers(-1, 2, size=3)  # down, stay, up
            moved = np.nextafter(v.position, np.where(step > 0, np.inf, -np.inf))
            v.position[:] = np.where(step == 0, v.position, moved)
    gp = mesh.global_parameters
    mn = pkg.Minimizer(mesh, stepper=make_stepper("gd"),
                       step_size=float(gp.get("step_size", 1e-3)), tol=1e-6, quiet=True)
    ctx = CommandContext(mesh=mesh, minimizer=mn, stepper=mn.stepper)
    rows = []
    for cmd in expanded(data["instructions"]):
        execute_command_line(ctx, cmd)
        ctx.sync_mesh()
        rows.append((cmd, float(mn.compute_energy()), float(mn.step_size)))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lanes", nargs="+")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("-o", "--output", type=Path, help="write the records here, by lane")
    args = ap.parse_args()
    os.environ.setdefault("MEMBRANE_SOLVER_X64", "1")
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    records = {}
    for name in args.lanes:
        clean = run(name, None)
        noisy = [run(name, seed) for seed in range(args.seeds)]
        spread = [max(abs(r[k][1] - clean[k][1]) / abs(clean[k][1]) for r in noisy)
                  for k in range(len(clean))]
        flips = [next((k for k in range(len(clean)) if r[k][2] != clean[k][2]), None)
                 for r in noisy]
        records[name] = {"seeds": args.seeds, "commands": [r[0] for r in clean],
                         "energies": [r[1] for r in clean], "step_sizes": [r[2] for r in clean],
                         "spread": spread, "first_step_size_flip": flips,
                         "final_spread": spread[-1]}
        print(json.dumps({"lane": name, **records[name]}), flush=True)
    if args.output is not None:
        args.output.write_text(json.dumps(records, indent=1) + "\n")


if __name__ == "__main__":
    main()
