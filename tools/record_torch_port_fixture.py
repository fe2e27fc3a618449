#!/usr/bin/env python3
"""Record the JAX package's reference trajectories for the PyTorch port.

Runs six protocols with ``membrane_solver_tpu`` on the CPU in float64 and
writes one JSON file each to ``tests/fixtures/torch_port/``:

``kozlov_L3_f64_jax.json`` (the kozlov coupled-tilt lane):

1. ``meshgen.build("kozlov_1disk")`` -> ``parse_geometry``, with the bench
   global parameters (coupled tilt solve, fixed step 0.005);
2. ``Minimizer``, then ``step_size = 0.005``;
3. three refinement rounds (polygonal -> triangle refine, invalidate,
   enforce constraints after mesh ops): 10,817 vertices, 21,504 triangles;
4. five calls of ``minimize(1)``.

``helfrich_cube_L5_f64_jax.json`` (the Helfrich vesicle: surface tension
plus Helfrich bending under a hard volume constraint, cube -> sphere):

1. ``meshgen.build("cube")`` without its instructions, energy modules
   ``surface`` + ``bending``, constraint module ``volume``, global
   parameters ``bending_modulus`` 1.0 and ``volume_constraint_mode``
   "lagrange" (the cube keeps its target volume 1.0 and its per-trial
   volume projection);
2. ``Minimizer`` with its defaults (step 0.001, adaptive step size);
3. ``refine_polygonal_facets`` once, then five rounds of triangle refine,
   invalidate, enforce constraints after mesh ops: 12,290 vertices,
   24,576 triangles;
4. five calls of ``minimize(1)``.

Each of these two files holds the vertex/triangle counts, the energy
before the first step and the per-step energies.

``cube_cli_L5_f64_jax.json`` (the CLI's cube recipe, extended to L5): the
command context as ``cli.main`` builds it for ``-q --non-interactive -i
meshes/cube.json`` (gradient descent, the file's step size, tol 1e-6; no
capacity plan, which would pad BFGS's dense inverse Hessian to the
recipe's final 12,290 vertices), then, through
``commands.execute_command_line``, the file's own recipe (``g50; r; u;
V2; ...; g200``, 770 vertices), the stepper segment ``bfgs; g10; hessian
2; cg; g20; gd``, and ``r; u; V2; g20; r; u; V2; cg; g20; energy stats``
up to 12,290 vertices and 24,576 triangles.  Per command: the energy, the
vertex and facet counts, the total volume and the step size after it.  Its
``float32_reference`` block holds the same commands run by the JAX package
at float32 (a child process with ``MEMBRANE_SOLVER_X64=0``): per-command
energies and their largest relative deviation from the float64 trace.  On
this protocol float32 line searches fail near the recipe's minimum, the
step size decays, and the float32 run falls behind, so ``chip_smoke.py``
bounds the port's float32-vs-float64 deviation by twice this value.

``square_to_circle_L1_f64_jax.json`` (the shape family's lane: line
tension on the boundary of a flat square sheet under a hard global area
constraint, surface tension 0): meshgen ``square_to_circle`` at ``n`` = 56
(3,249 vertices, 6,272 triangles), written to a JSON file and run through
the same command context with the builder's own recipe ``g40; r; g40; u;
V4; g60`` (12,769 vertices and 25,088 triangles after ``r``), with the
same per-command rows and ``float32_reference``.

In both command-layer files the ``float32_reference`` rows also hold, per
command, the vertex and facet counts and the connectivity digest of
``chip_smoke.connectivity_digest`` (the facets' signed edge lists and the
edges' endpoints), so the GPU run can tell whether its float32 mesh
operations part from the JAX package's own float32 ones.

``rect_tilt_source_L0_f64_jax.json`` (the single-field tilt lane): meshgen
``rect_tilt_source`` at ``nx`` = 160, ``ny`` = 64 (10,465 vertices, 20,480
triangles; the builder's length 5, width 2 and square cells), written to a
JSON file and run through the same command context with the builder's
recipe ``g5`` (nested tilt solve, 60 inner CG steps) as five ``g1``
commands, with the same per-command rows and ``float32_reference``.

``kozlov_L3_thetaB_f64_jax.json`` (the theta_B scan): the kozlov protocol
above (three refinements, five ``minimize(1)``), then the scan parameters
of ``tests/test_inloop_relax_semantics.py`` (``THETAB_GP``: coupled solve
with 6 inner steps, a scan every iteration with delta 0.01 and 4 inner
steps, theta_B from 0.05) and one ``minimize(3)``.  It holds the
``_thetaB_scan_trace`` records (per scan: the base and selected theta_B,
each candidate's energy and breakdown) and the final energy; its
``float32_reference`` holds the same run at float32 (selected theta_B per
scan, candidate and final energies, their largest relative deviation from
float64).

``chip_smoke.py`` holds the port's float64 runs on the GPU against these
files, so the GPU machine needs no JAX.

Usage::

    python tools/record_torch_port_fixture.py [--output-dir DIR] [--only NAME ...]

Each file's ``protocol`` block is the one definition of its protocol:
``chip_smoke.py`` and the port's CPU tests read it from there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT_DIR = REPO / "tests" / "fixtures" / "torch_port"

# the bench lane's global parameters (bench.py LANES["kozlov"])
BENCH_GP = {
    "tilt_solve_mode": "coupled",
    "tilt_step_size": 0.15,
    "tilt_inner_steps": 40,
    "tilt_tol": 1e-10,
    "step_size": 0.005,
    "step_size_mode": "fixed",
}
KOZLOV_STEP_SIZE = 0.005
KOZLOV_REFINES = 3  # 10,817 vertices, 21,504 triangles
STEPS = 5

# the vesicle lane: the reference's bending lane module set
# (tests/fixtures/reference_lane_traces.json "bending"; tools/suite.py)
VESICLE_GP = {"bending_modulus": 1.0, "volume_constraint_mode": "lagrange"}
VESICLE_ENERGY = ["surface", "bending"]
VESICLE_CONSTRAINTS = ["volume"]
VESICLE_STEP_SIZE = 0.001  # the Minimizer's default
VESICLE_REFINES = 5  # 12,290 vertices, 24,576 triangles


def _jax():
    os.environ.setdefault("MEMBRANE_SOLVER_X64", "1")
    os.environ.setdefault("MEMBRANE_SOLVER_AOT_CACHE", "0")
    os.environ.setdefault("MEMBRANE_SOLVER_COMPILE_CACHE", "0")
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import membrane_solver_tpu as pkg
    from membrane_solver_tpu.meshgen import build
    from membrane_solver_tpu.runtime import refinement

    return pkg, build, refinement


def _trajectory(mn) -> dict:
    energy0 = float(mn.compute_energy())
    breakdown = {k: float(v) for k, v in mn.compute_energy_breakdown().items()}
    energies, step_sizes = [], []
    for _ in range(STEPS):
        energies.append(float(mn.minimize(1)["energy"]))
        step_sizes.append(float(mn.step_size))
    return {
        "n_vertices": len(mn.mesh.vertices),
        "n_triangles": len(mn.mesh.facets),
        "energy_before": energy0,
        "breakdown_before": breakdown,
        "energies": energies,
        "step_sizes": step_sizes,
    }


def kozlov_minimizer(gp=None):
    """The kozlov protocol up to its first step, in the JAX package (``gp``: its global parameters)."""
    pkg, build, refinement = _jax()
    mesh = pkg.parse_geometry(build("kozlov_1disk"))
    mesh.global_parameters.update(BENCH_GP if gp is None else gp)
    mn = pkg.Minimizer(mesh, quiet=True)
    mn.step_size = KOZLOV_STEP_SIZE
    for _ in range(KOZLOV_REFINES):
        m = refinement.refine_polygonal_facets(mn.mesh)
        m = refinement.refine_triangle_mesh(m)
        mn.mesh = m
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    return mn


def kozlov_protocol() -> dict:
    return {
        "mesh": "meshgen kozlov_1disk",
        "global_parameters": BENCH_GP,
        "step_size": KOZLOV_STEP_SIZE,
        "refines": KOZLOV_REFINES,
        "steps": STEPS,
        "dtype": "float64",
        "package": "membrane_solver_tpu",
        "platform": "cpu",
    }


def run_kozlov() -> dict:
    rec = {"protocol": kozlov_protocol()}
    rec.update(_trajectory(kozlov_minimizer()))
    return rec


# the theta_B scan's parameters (tests/test_inloop_relax_semantics.py,
# test_scan_iteration_relaxes_before_scoring) and its minimize call
THETAB_GP = {
    "tilt_solve_mode": "coupled",
    "tilt_step_size": 0.15,
    "tilt_inner_steps": 6,
    "tilt_tol": 1e-10,
    "tilt_thetaB_optimize": True,
    "tilt_thetaB_optimize_every": 1,
    "tilt_thetaB_optimize_delta": 0.01,
    "tilt_thetaB_optimize_inner_steps": 4,
    "tilt_thetaB_value": 0.05,
}
THETAB_STEPS = 3


def thetaB_run() -> dict:
    """The theta_B protocol at the precision this process runs."""
    mn = kozlov_minimizer()
    for _ in range(STEPS):
        mn.minimize(1)
    mn.global_params.update(THETAB_GP)
    res = mn.minimize(THETAB_STEPS)
    return {
        "n_vertices": len(mn.mesh.vertices),
        "n_triangles": len(mn.mesh.facets),
        "trace": mn.mesh._thetaB_scan_trace,
        "energy": float(res["energy"]),
        "thetaB_after": float(mn.global_params.get("tilt_thetaB_value")),
    }


def run_kozlov_thetaB() -> dict:
    protocol = {"kozlov": kozlov_protocol(), "global_parameters": THETAB_GP,
                "minimize": THETAB_STEPS, "dtype": "float64", "package": "membrane_solver_tpu",
                "platform": "cpu"}
    rec = {"protocol": protocol, **thetaB_run()}
    f32 = float32_child("kozlov_L3_thetaB_f64_jax.json")
    from chip_smoke import thetaB_energies

    e32, e64 = (thetaB_energies(r["trace"], r["energy"]) for r in (f32, rec))
    devs = [abs(a - b) / abs(b) for a, b in zip(e32, e64, strict=True)]
    rec["float32_reference"] = {
        "package": "membrane_solver_tpu", "platform": "cpu", "dtype": "float32",
        "selected_thetaB": [r["selected_thetaB"] for r in f32["trace"]],
        "energies": e32, "max_rel_dev_vs_float64": max(devs)}
    return rec


# the reduced-energy line search on the kozlov lane: every Armijo trial
# re-relaxes both leaflet tilts (10 inner steps, the default of
# line_search_reduced_tilt_inner_steps) before it is scored, with the
# shared-rim staggered rim matching
REDUCED_GP = {
    "line_search_reduced_energy": "on",
    "rim_slope_match_mode": "shared_rim_staggered_v1",
}


def kozlov_reduced_protocol() -> dict:
    return {**kozlov_protocol(), "global_parameters": {**BENCH_GP, **REDUCED_GP}}


def reduced_run() -> dict:
    """The reduced-line-search protocol at the precision this process runs."""
    protocol = kozlov_reduced_protocol()
    mn = kozlov_minimizer(protocol["global_parameters"])
    energy0 = float(mn.compute_energy())
    energies, accepted, step_sizes = [], [], []
    for _ in range(protocol["steps"]):
        res = mn.minimize(1)
        energies.append(float(res["energy"]))
        accepted.append(bool(res["step_success"]))
        step_sizes.append(float(mn.step_size))
    return {
        "n_vertices": len(mn.mesh.vertices),
        "n_triangles": len(mn.mesh.facets),
        "energy_before": energy0,
        "energies": energies,
        "accepted": accepted,
        "step_sizes": step_sizes,
        "energy_after": float(mn.compute_energy()),
        "breakdown_after": {k: float(v) for k, v in mn.compute_energy_breakdown().items()},
    }


def run_kozlov_reduced() -> dict:
    child = start_float32_child("kozlov_L3_reduced_f64_jax.json")  # runs beside float64
    rec = {"protocol": kozlov_reduced_protocol(), **reduced_run()}
    f32 = float32_result(child)
    e32, e64 = (r["energies"] + [r["energy_after"]] for r in (f32, rec))
    devs = [abs(a - b) / abs(b) for a, b in zip(e32, e64, strict=True)]
    rec["float32_reference"] = {
        "package": "membrane_solver_tpu", "platform": "cpu", "dtype": "float32",
        "energies": f32["energies"], "accepted": f32["accepted"],
        "energy_after": f32["energy_after"], "max_rel_dev_vs_float64": max(devs)}
    return rec


def vesicle_protocol(refines: int = VESICLE_REFINES) -> dict:
    return {
        "mesh": "meshgen cube",
        "drop_instructions": True,
        "energy_modules": VESICLE_ENERGY,
        "constraint_modules": VESICLE_CONSTRAINTS,
        "global_parameters": VESICLE_GP,
        "step_size": VESICLE_STEP_SIZE,
        "polygonal_refines": 1,
        "refines": refines,
        "steps": STEPS,
        "dtype": "float64",
        "package": "membrane_solver_tpu",
        "platform": "cpu",
    }


def build_vesicle(pkg, build, refinement, protocol: dict, **minimizer_kw):
    """The vesicle protocol up to the first step, for either package."""
    data = build("cube")
    if protocol["drop_instructions"]:
        data.pop("instructions", None)
    data["energy_modules"] = list(protocol["energy_modules"])
    data["constraint_modules"] = list(protocol["constraint_modules"])
    data["global_parameters"].update(protocol["global_parameters"])
    mn = pkg.Minimizer(pkg.parse_geometry(data), quiet=True, **minimizer_kw)
    mn.step_size = protocol["step_size"]
    for _ in range(protocol["polygonal_refines"]):
        mn.mesh = refinement.refine_polygonal_facets(mn.mesh)
    for _ in range(protocol["refines"]):
        mn.mesh = refinement.refine_triangle_mesh(mn.mesh)
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    return mn


def run_vesicle() -> dict:
    pkg, build, refinement = _jax()
    protocol = vesicle_protocol()
    rec = {"protocol": protocol}
    rec.update(_trajectory(build_vesicle(pkg, build, refinement, protocol)))
    return rec


CUBE_MESH = "meshes/cube.json"
STEPPER_SEGMENT = ["bfgs", "g10", "hessian 2", "cg", "g20", "gd"]
L5_EXTENSION = ["r", "u", "V2", "g20", "r", "u", "V2", "cg", "g20", "energy stats"]
# square_to_circle's sheet size: 12,769 vertices after the recipe's ``r``
SQUARE_N = 56
# rect_tilt_source's sheet: 161 x 65 = 10,465 vertices, kozlov L3's size
RECT_NX, RECT_NY = 160, 64


def cube_cli_protocol() -> dict:
    recipe = json.loads((REPO / CUBE_MESH).read_text())["instructions"]
    return {
        "mesh": CUBE_MESH,
        "cli_args": ["-q", "--non-interactive", "-i", CUBE_MESH],
        "recipe": list(recipe),
        "stepper_segment": STEPPER_SEGMENT,
        "l5_extension": L5_EXTENSION,
        "commands": list(recipe) + STEPPER_SEGMENT + L5_EXTENSION,
        "dtype": "float64",
        "package": "membrane_solver_tpu",
        "platform": "cpu",
    }


def square_to_circle_protocol(n: int = SQUARE_N) -> dict:
    """The builder's recipe at sheet size ``n``; ``mesh`` names the JSON file to write."""
    _pkg, build, _refinement = _jax()
    recipe = build("square_to_circle", n=n)["instructions"]
    return {
        "mesh": "square_to_circle.json",
        "meshgen": {"name": "square_to_circle", "args": {"n": n}},
        "cli_args": ["-q", "--non-interactive", "-i", "square_to_circle.json"],
        "recipe": list(recipe),
        "commands": list(recipe),
        "dtype": "float64",
        "package": "membrane_solver_tpu",
        "platform": "cpu",
    }


def rect_tilt_source_protocol(nx: int = RECT_NX, ny: int = RECT_NY) -> dict:
    """The builder's recipe ``g5`` as five ``g1`` commands, so each step's energy is kept."""
    _pkg, build, _refinement = _jax()
    from tools.lane_noise_spread import expanded

    recipe = build("rect_tilt_source", nx=nx, ny=ny)["instructions"]
    return {
        "mesh": "rect_tilt_source.json",
        "meshgen": {"name": "rect_tilt_source", "args": {"nx": nx, "ny": ny}},
        "cli_args": ["-q", "--non-interactive", "-i", "rect_tilt_source.json"],
        "recipe": list(recipe),
        "commands": expanded(recipe),
        "dtype": "float64",
        "package": "membrane_solver_tpu",
        "platform": "cpu",
    }


def command_record(ctx, cmd: str) -> dict:
    """One command's row: the state after it, read from either package's context."""
    mn = ctx.minimizer
    return {
        "cmd": cmd,
        "energy": float(mn.compute_energy()),
        "n_vertices": len(mn.mesh.vertices),
        "n_facets": len(mn.mesh.facets),
        "volume": float(mn.mesh.compute_total_volume()),
        "step_size": float(mn.step_size),
    }


def mesh_path(protocol: dict, workdir: Path) -> Path:
    """The protocol's input file: a repository mesh, or its meshgen lane written to ``workdir``."""
    spec = protocol.get("meshgen")
    if spec is None:
        return REPO / protocol["mesh"]
    _pkg, build, _refinement = _jax()
    path = workdir / protocol["mesh"]
    path.write_text(json.dumps(build(spec["name"], **spec["args"])))
    return path


def cli_trace(protocol: dict, digests: bool = False) -> list:
    """The protocol's commands in the JAX package, at the precision this process runs.

    With ``digests``, each row also holds the connectivity digest after it.
    """
    import tempfile

    pkg, _build, _refinement = _jax()
    from chip_smoke import connectivity_digest
    from membrane_solver_tpu.commands import CommandContext, execute_command_line
    from membrane_solver_tpu.runtime.steppers import make_stepper

    with tempfile.TemporaryDirectory() as tmp:
        mesh = pkg.parse_geometry(pkg.load_data(mesh_path(protocol, Path(tmp))))
    gp = mesh.global_parameters
    # as cli.main builds it, less the capacity plan (see the docstring)
    mn = pkg.Minimizer(mesh, stepper=make_stepper("gd"),
                       step_size=float(gp.get("step_size", 1e-3)), tol=1e-6, quiet=True)
    ctx = CommandContext(mesh=mesh, minimizer=mn, stepper=mn.stepper)
    trace = []
    for cmd in protocol["commands"]:
        execute_command_line(ctx, cmd)
        ctx.sync_mesh()
        trace.append(command_record(ctx, cmd))
        if digests:
            trace[-1]["connectivity"] = connectivity_digest(ctx.mesh)
    return trace


CLI_PROTOCOLS = {
    "cube_cli_L5_f64_jax.json": cube_cli_protocol,
    "square_to_circle_L1_f64_jax.json": square_to_circle_protocol,
    "rect_tilt_source_L0_f64_jax.json": rect_tilt_source_protocol,
}

# what the float32 child of a fixture runs
FLOAT32_RUNS = {
    **{name: (lambda name=name: cli_trace(CLI_PROTOCOLS[name](), digests=True))
       for name in CLI_PROTOCOLS},
    "kozlov_L3_thetaB_f64_jax.json": thetaB_run,
    "kozlov_L3_reduced_f64_jax.json": reduced_run,
}


def start_float32_child(name: str) -> subprocess.Popen:
    """Start ``FLOAT32_RUNS[name]()`` in a child process with x64 off."""
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--float32", name],
        env={**os.environ, "MEMBRANE_SOLVER_X64": "0"}, stdout=subprocess.PIPE, text=True,
    )


def float32_result(child: subprocess.Popen):
    """The last stdout line of a :func:`start_float32_child` child, as JSON."""
    out, _ = child.communicate()
    if child.returncode != 0:
        raise subprocess.CalledProcessError(child.returncode, child.args)
    return json.loads(out.strip().splitlines()[-1])


def float32_child(name: str):
    """``FLOAT32_RUNS[name]()`` in a child process with x64 off."""
    return float32_result(start_float32_child(name))


def run_cli_fixture(name: str) -> dict:
    """The float64 trace in this process, the float32 one in a child with x64 off."""
    protocol = CLI_PROTOCOLS[name]()
    trace = cli_trace(protocol)
    rows = float32_child(name)
    devs = [abs(r["energy"] - t["energy"]) / abs(t["energy"])
            for r, t in zip(rows, trace, strict=True)]
    f32 = {"package": "membrane_solver_tpu", "platform": "cpu", "dtype": "float32",
           "energies": [r["energy"] for r in rows], "max_rel_dev_vs_float64": max(devs),
           "counts": [[r["n_vertices"], r["n_facets"]] for r in rows],
           "connectivity": [r["connectivity"] for r in rows]}
    return {"protocol": protocol, "trace": trace, "float32_reference": f32}


FIXTURES = {
    "kozlov_L3_f64_jax.json": run_kozlov,
    "helfrich_cube_L5_f64_jax.json": run_vesicle,
    **{name: (lambda name=name: run_cli_fixture(name)) for name in CLI_PROTOCOLS},
    "kozlov_L3_thetaB_f64_jax.json": run_kozlov_thetaB,
    "kozlov_L3_reduced_f64_jax.json": run_kozlov_reduced,
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output-dir", type=Path, default=OUT_DIR)
    ap.add_argument("--only", nargs="+", choices=sorted(FIXTURES),
                    help="record these files only (default: all)")
    ap.add_argument("--float32", choices=sorted(FLOAT32_RUNS),
                    help=argparse.SUPPRESS)  # the child of float32_child
    args = ap.parse_args()
    if args.float32:
        print(json.dumps(FLOAT32_RUNS[args.float32]()), flush=True)
        return
    args.output_dir.mkdir(parents=True, exist_ok=True)
    for name in args.only or FIXTURES:
        rec = FIXTURES[name]()
        (args.output_dir / name).write_text(json.dumps(rec, indent=1) + "\n")
        print(name, json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
