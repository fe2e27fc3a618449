#!/usr/bin/env python3
"""Record the JAX package's kozlov L3 trajectory for the PyTorch port.

Runs the kozlov coupled-tilt protocol with ``membrane_solver_tpu`` on the CPU
in float64:

1. ``meshgen.build("kozlov_1disk")`` -> ``parse_geometry``, with the bench
   global parameters (coupled tilt solve, fixed step 0.005);
2. ``Minimizer``, then ``step_size = 0.005``;
3. three refinement rounds (polygonal -> triangle refine, invalidate,
   enforce constraints after mesh ops);
4. five calls of ``minimize(1)``.

and writes the vertex/triangle counts, the energy before the first step and
the five per-step energies to
``tests/fixtures/torch_port/kozlov_L3_f64_jax.json``.  ``chip_smoke.py``
holds the port's float64 run on the GPU against this file, so the GPU
machine needs no JAX.

Usage::

    python tools/record_torch_port_fixture.py [-o PATH]

The file's ``protocol`` block is the one definition of the protocol:
``chip_smoke.py`` and the port's CPU tests read it from there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "fixtures" / "torch_port" / "kozlov_L3_f64_jax.json"

# the bench lane's global parameters (bench.py LANES["kozlov"])
BENCH_GP = {
    "tilt_solve_mode": "coupled",
    "tilt_step_size": 0.15,
    "tilt_inner_steps": 40,
    "tilt_tol": 1e-10,
    "step_size": 0.005,
    "step_size_mode": "fixed",
}
STEP_SIZE = 0.005
REFINES = 3  # 10,817 vertices, 21,504 triangles
STEPS = 5


def run() -> dict:
    os.environ.setdefault("MEMBRANE_SOLVER_X64", "1")
    os.environ.setdefault("MEMBRANE_SOLVER_AOT_CACHE", "0")
    os.environ.setdefault("MEMBRANE_SOLVER_COMPILE_CACHE", "0")
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from membrane_solver_tpu import Minimizer, parse_geometry
    from membrane_solver_tpu.meshgen import build
    from membrane_solver_tpu.runtime.refinement import (
        refine_polygonal_facets,
        refine_triangle_mesh,
    )

    mesh = parse_geometry(build("kozlov_1disk"))
    mesh.global_parameters.update(BENCH_GP)
    mn = Minimizer(mesh, quiet=True)
    mn.step_size = STEP_SIZE
    for _ in range(REFINES):
        m = refine_polygonal_facets(mn.mesh)
        m = refine_triangle_mesh(m)
        mn.mesh = m
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    energy0 = float(mn.compute_energy())
    energies = []
    for _ in range(STEPS):
        energies.append(float(mn.minimize(1)["energy"]))
    return {
        "protocol": {
            "mesh": "meshgen kozlov_1disk",
            "global_parameters": BENCH_GP,
            "step_size": STEP_SIZE,
            "refines": REFINES,
            "steps": STEPS,
            "dtype": "float64",
            "package": "membrane_solver_tpu",
            "platform": "cpu",
        },
        "n_vertices": len(mn.mesh.vertices),
        "n_triangles": len(mn.mesh.facets),
        "energy_before": energy0,
        "energies": energies,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-o", "--output", type=Path, default=OUT)
    args = ap.parse_args()
    rec = run()
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text(json.dumps(rec, indent=1) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
