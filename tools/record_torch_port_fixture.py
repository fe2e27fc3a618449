#!/usr/bin/env python3
"""Record the JAX package's reference trajectories for the PyTorch port.

Runs twelve protocols with ``membrane_solver_tpu`` on the CPU in float64 and
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

``kozlov_L3_reduced_f64_jax.json`` and ``kozlov_L3_smooth_f64_jax.json``
(``lane_run``): the kozlov protocol with the reduced-energy line search
and shared-rim staggered rim matching, and with ``tilt_smoothness_in`` and
``tilt_smoothness_out`` added to the energy modules (the protocol's
``extra_energy_modules``): per step the energy, the accept flag and the
step size, the breakdown before and after; their ``float32_reference``
holds the float32 energies, flags and final breakdown, and the largest
relative deviation from float64.

``kozlov_L3_drives_f64_jax.json`` (``drives_run``): the kozlov mesh after
its three refinements with ``tests/test_module_gradients_fd.py``'s set-up
(``chip_smoke.drives_setup``); the inputs and, per leaflet tilt-field
energy, its value and its gradients in the positions and both leaflet
tilts, encoded by ``chip_smoke.encode_rows``; its ``float32_reference``
holds each module's float32 deviation (energy, and each gradient relative
to its largest entry).

``kozlov_L3_free_disk_f64_jax.json`` and ``kozlov_L3_interface_f64_jax.json``
(``lane_run``, with ``chip_smoke.lane_edits``): the kozlov protocol with
``rigid_disk`` appended and the disk's own ``pin_to_plane`` dropped at L0
(the disk a rigid body about its fixed center vertex), and with
``rim_slope_match_out`` replaced by ``curved_local_interface_hard`` plus the
``curved_local_interface_law`` energy.  Per step also the multiplier-finite
flag of the shape KKT solves (``kkt_recorder``), their largest multiplier
and the breakdown after the step; and (``step_recorder``) the accepted CG
steps of each leaflet relax and whether the step took the rejected-step
``trace_z`` fallback, both also in ``float32_reference``.

``physical_edge_L0_noise.json`` (``physical_edge_L0_noise``): the two
protocols below at L0, two steps, clean and under 1e-15 of z noise.

``kozlov_L3_physical_edge_f64_jax.json`` and ``kozlov_L3_scaffold_f64_jax.json``
(``lane_run``): the kozlov protocol with ``rim_slope_match_mode``
``physical_edge_staggered_v1`` (the disk-targeted flavour), and the same with
the scaffold-trace switches (``SCAFFOLD_GP``) and, after the refinements,
the trace shell and three scaffold shells tagged (``chip_smoke.lane_tags``,
the protocol's ``scaffold_tags``); each also holds the compiled shells
(``shells``: radii, conditions, shell rows, shared targets).

``kozlov_L3_match_drives_f64_jax.json`` (``match_drives_run``): the kozlov
mesh after its refinements with ``chip_smoke.match_drives_setup``; the
inputs and, per energy of the local-interface family, its value and its
gradients in the positions and all three tilt fields; per constraint and
mode, its dense tilt rows and the change its tilt enforcement makes; the
rigid disk's double fit; its ``float32_reference`` holds the float32
deviations per item (``chip_smoke.match_deviations``).

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


def kozlov_minimizer(gp=None, edits=None, refines=KOZLOV_REFINES):
    """The kozlov protocol up to its first step, in the JAX package.

    ``gp``: its global parameters (default the bench's); ``edits``: a
    protocol whose module and free-disk changes ``chip_smoke.lane_edits``
    makes to the L0 mesh (its ``extra_energy_modules`` among them) and whose
    vertex tags ``chip_smoke.lane_tags`` sets after the refinements;
    ``refines``: the refinement rounds.
    """
    pkg, build, refinement = _jax()
    from chip_smoke import lane_edits, lane_tags

    mesh = pkg.parse_geometry(build("kozlov_1disk"))
    mesh.global_parameters.update(BENCH_GP if gp is None else gp)
    lane_edits(mesh, edits or {})
    mn = pkg.Minimizer(mesh, quiet=True)
    mn.step_size = KOZLOV_STEP_SIZE
    for _ in range(refines):
        m = refinement.refine_polygonal_facets(mn.mesh)
        m = refinement.refine_triangle_mesh(m)
        mn.mesh = m
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    lane_tags(mn, edits or {})
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


# the kozlov lane with the Dirichlet tilt smoothness of both leaflets: the
# frozen-tilt kernel's smoothness columns (w_in, w_out) carry it on the card
SMOOTH_MODULES = ["tilt_smoothness_in", "tilt_smoothness_out"]


def kozlov_smooth_protocol() -> dict:
    return {**kozlov_protocol(), "extra_energy_modules": SMOOTH_MODULES}


def kkt_recorder() -> list:
    """Record each shape KKT solve of the JAX package from here on: (multipliers finite, max|lam|).

    Wraps ``jit_core._solve_kkt_with_rescue`` (the same arithmetic, plus a
    host callback) before the minimize block is traced; the caches that
    would skip the tracing are off in this process (``_jax``).
    """
    import jax
    import jax.numpy as jnp

    _jax()
    from membrane_solver_tpu.runtime import jit_core

    solves = []

    def record(finite, lam_max):
        solves.append((bool(finite), float(lam_max)))

    def solve(A, b, k):
        lam = jit_core.dlinalg.solve_spd(A, b)
        finite = jnp.all(jnp.isfinite(lam))
        jax.debug.callback(record, finite, jnp.max(jnp.abs(lam)))
        return jnp.where(finite, lam, jnp.zeros_like(lam))

    jit_core._solve_kkt_with_rescue = solve
    return solves


def step_recorder() -> dict:
    """Record, from here on, each leaflet relax's accepted CG steps and each Armijo line search.

    Wraps ``tilt_relax.make_relax_leaflet_tilts`` and
    ``jit_core.armijo_line_search`` (the same arithmetic, plus a host
    callback) before the minimize block is traced (caches off, ``_jax``).
    A step whose block ran two line searches took the rejected-step
    ``trace_z`` fallback: the second runs only under that branch.
    """
    import jax

    _jax()
    from membrane_solver_tpu.runtime import jit_core
    from membrane_solver_tpu.runtime import tilt_relax

    rec = {"relax": [], "line_searches": []}
    make_relax, armijo = tilt_relax.make_relax_leaflet_tilts, jit_core.armijo_line_search

    def relax_maker(spec):
        fn = make_relax(spec)

        def relax(*args, **kw):
            state, stats = fn(*args, **kw)
            jax.debug.callback(lambda n: rec["relax"].append(int(n)), stats.accepted_steps)
            return state, stats

        return relax

    def line_search(*args, **kw):
        ls = armijo(*args, **kw)
        jax.debug.callback(lambda ok: rec["line_searches"].append(bool(ok)), ls.success)
        return ls

    tilt_relax.make_relax_leaflet_tilts = relax_maker
    jit_core.armijo_line_search = line_search
    return rec


def shell_record(mn) -> dict | None:
    """The physical-edge rim placement's compiled shells: radii, row counts, shared targets."""
    import numpy as np

    p = mn.problem()
    key = "constraint:rim_slope_match_out"
    if f"{key}/shell_radii" not in p.topo.extras:
        return None
    ex = {k: np.asarray(v) for k, v in p.topo.extras.items() if k.startswith(key)}
    n = int(ex[f"{key}/valid"].sum())
    outer = ex[f"{key}/outer"][:n]
    disk_r, rim_r, outer_r = (float(x) for x in ex[f"{key}/shell_radii"])
    return {"disk_radius": disk_r, "rim_radius": rim_r, "outer_radius": outer_r,
            "conditions": n, "shell_rows": int(np.unique(outer).size),
            "most_conditions_per_row": int(np.bincount(outer).max()),
            "shared_targets": bool(p.spec.static_of(key)[12])}


def lane_run(protocol: dict) -> dict:
    """A kozlov protocol's steps at the precision this process runs, with its accept flags.

    Per step also whether every shape KKT solve gave finite multipliers
    (``multipliers_finite``), their largest size, the energy breakdown after
    the step, the accepted CG steps of each leaflet relax the step ran
    (``relax_accepted_steps``) and whether it took the ``trace_z`` fallback
    (``trace_z``); on the physical-edge lanes the compiled shells.
    """
    import jax

    solves = kkt_recorder()
    steps = step_recorder()
    mn = kozlov_minimizer(protocol["global_parameters"], edits=protocol)
    energy0 = float(mn.compute_energy())
    breakdown0 = {k: float(v) for k, v in mn.compute_energy_breakdown().items()}
    energies, accepted, step_sizes, finite, lam_max, breakdowns = [], [], [], [], [], []
    relax_counts, trace_z = [], []
    for _ in range(protocol["steps"]):
        first = len(solves)
        n_relax, n_ls = len(steps["relax"]), len(steps["line_searches"])
        res = mn.minimize(1)
        jax.effects_barrier()
        energies.append(float(res["energy"]))
        accepted.append(bool(res["step_success"]))
        step_sizes.append(float(mn.step_size))
        finite.append(all(f for f, _m in solves[first:]))
        lam_max.append(max((m for _f, m in solves[first:]), default=0.0))
        breakdowns.append({k: float(v) for k, v in mn.compute_energy_breakdown().items()})
        relax_counts.append(steps["relax"][n_relax:])
        trace_z.append(len(steps["line_searches"]) - n_ls > 1)
    out = {
        "n_vertices": len(mn.mesh.vertices),
        "n_triangles": len(mn.mesh.facets),
        "energy_before": energy0,
        "breakdown_before": breakdown0,
        "energies": energies,
        "accepted": accepted,
        "step_sizes": step_sizes,
        "multipliers_finite": finite,
        "multipliers_max_abs": lam_max,
        "breakdowns": breakdowns,
        "relax_accepted_steps": relax_counts,
        "trace_z": trace_z,
        "energy_after": float(mn.compute_energy()),
        "breakdown_after": {k: float(v) for k, v in mn.compute_energy_breakdown().items()},
    }
    shells = shell_record(mn)
    if shells is not None:
        out["shells"] = shells
    return out


def run_lane_fixture(name: str, protocol: dict) -> dict:
    """``lane_run`` at float64 here and at float32 in a child beside it (``LANE_PROTOCOLS``)."""
    child = start_float32_child(name)
    rec = {"protocol": protocol, **lane_run(protocol)}
    f32 = float32_result(child)
    e32, e64 = (r["energies"] + [r["energy_after"]] for r in (f32, rec))
    devs = [abs(a - b) / abs(b) for a, b in zip(e32, e64, strict=True)]
    rec["float32_reference"] = {
        "package": "membrane_solver_tpu", "platform": "cpu", "dtype": "float32",
        "energies": f32["energies"], "accepted": f32["accepted"],
        "multipliers_finite": f32["multipliers_finite"],
        "relax_accepted_steps": f32["relax_accepted_steps"], "trace_z": f32["trace_z"],
        "energy_after": f32["energy_after"], "breakdown_after": f32["breakdown_after"],
        "max_rel_dev_vs_float64": max(devs)}
    return rec


# the free-disk lane: rigid_disk appended with no rigid_disk_group (the
# preset-disk fallback, 1,611 vertices at L3) and the disk's own pin_to_plane
# dropped at L0, so the disk moves as one rigid body about its fixed center
# vertex.  Its pairwise KKT rows are rank-deficient by construction (a planar
# disk).  The fixture keeps the breakdown after each step: the refined disk
# group that tilt_thetaB_contact_in's work term reads as a ring is a patch of
# the disk ordered by angle, the rigid fit moves it by round-off at every
# enforcement, and that term (bookkeeping, no gradient) follows the order.
def kozlov_free_disk_protocol() -> dict:
    return {**kozlov_protocol(), "extra_constraint_modules": ["rigid_disk"],
            "free_disk_preset": "disk"}


# the local-interface lane: rim_slope_match_out's hard rim matching replaced by
# the ring-averaged curved_local_interface_hard and the shape-aware law at
# tests/test_module_parity_extended.py's strength
INTERFACE_GP = {"curved_local_interface_law_strength": 0.8}


def kozlov_interface_protocol() -> dict:
    return {**kozlov_protocol(), "global_parameters": {**BENCH_GP, **INTERFACE_GP},
            "extra_energy_modules": ["curved_local_interface_law"],
            "extra_constraint_modules": ["curved_local_interface_hard"],
            "drop_constraint_modules": ["rim_slope_match_out"]}


# the physical-edge rim placement (local shells about the disk group) in its
# disk-targeted flavour, and its scaffold-trace lane: the trace shell at the
# radius of the first free ring outside the rim ring (the same 16-row shell
# at L0 and at L3), three scaffold shells, the theory-parity recovered inner
# divergence, the trace-reconstructed outer divergence, the trace-boundary
# inner stencil and the rejected-step trace_z fallback; the set-up tags the
# trace shell (pin_to_circle_group trace_layer) and the next three shells
# (outer_shell_scaffold_index) after the refinements (chip_smoke.lane_tags)
PHYSICAL_EDGE_GP = {"rim_slope_match_mode": "physical_edge_staggered_v1"}
TRACE_RADIUS = 1.364262
SCAFFOLD_GP = {
    **PHYSICAL_EDGE_GP,
    "parity_trace_layer_radius": TRACE_RADIUS,
    "parity_outer_shells": 3,
    "theory_parity_lane": "kozlov",
    "bending_tilt_interface_divergence_mode": "trace_reconstructed_v1",
    "bending_tilt_in_scaffold_shape_stencil_mode": "trace_boundary_v1",
    "shape_scaffold_rejected_step_fallback": "trace_z",
}


def kozlov_physical_edge_protocol() -> dict:
    return {**kozlov_protocol(), "global_parameters": {**BENCH_GP, **PHYSICAL_EDGE_GP}}


def kozlov_scaffold_protocol() -> dict:
    return {**kozlov_protocol(), "global_parameters": {**BENCH_GP, **SCAFFOLD_GP},
            "scaffold_tags": {"trace_radius": TRACE_RADIUS, "support_shells": 3}}


# the step-by-step kozlov lanes with their accept flags
LANE_PROTOCOLS = {
    "kozlov_L3_reduced_f64_jax.json": kozlov_reduced_protocol,
    "kozlov_L3_smooth_f64_jax.json": kozlov_smooth_protocol,
    "kozlov_L3_free_disk_f64_jax.json": kozlov_free_disk_protocol,
    "kozlov_L3_interface_f64_jax.json": kozlov_interface_protocol,
    "kozlov_L3_physical_edge_f64_jax.json": kozlov_physical_edge_protocol,
    "kozlov_L3_scaffold_f64_jax.json": kozlov_scaffold_protocol,
}


# the leaflet tilt-field drives: tests/test_module_gradients_fd.py's kozlov
# set-up (its global parameters, module list, ring tags and seeded tilts) on
# the kozlov lane's mesh after its three refinements
DRIVES_GP = {
    "tilt_coupling_modulus": 0.5,
    "tilt_splay_modulus_in": 0.7,
    "tilt_rim_source_strength_in": 0.3,
    "tilt_rim_source_strength_out": 0.3,
    "tilt_rim_source_strength": 0.25,
    "tilt_disk_target_strength_in": 0.4,
    "tilt_disk_target_value_in": 0.2,
    "tilt_disk_target_strength_out": 0.4,
    "tilt_disk_target_value_out": 0.15,
    "tilt_disk_contact_strength_in": 0.3,
    "tilt_coupling_mode": "difference",
    "tilt_rim_source_group_in": "rim",
    "tilt_rim_source_group_out": "rim",
    "tilt_rim_source_group": "rim",
    "tilt_rim_source_edge_mode": "all",
    "tilt_disk_target_group_in": "dt_ring",
    "tilt_disk_target_group_out": "dt_ring",
}
# the ten energy modules held (the unified smoothness module is not in the
# FD test's list; it is added to the mesh's modules here)
DRIVES_MODULES = [
    "tilt_splay_twist_in", "tilt_smoothness_in", "tilt_smoothness_out",
    "tilt_smoothness_leaflet", "tilt_rim_source_in", "tilt_rim_source_out",
    "tilt_rim_source_bilayer", "tilt_disk_target_in", "tilt_disk_target_out",
    "tilt_disk_contact_in",
]
FD_MODULES = [
    "tilt_in", "tilt_out", "tilt_coupling", "tilt_splay_twist_in", "tilt_smoothness_in",
    "tilt_smoothness_out", "tilt_rim_source_in", "tilt_rim_source_out",
    "tilt_rim_source_bilayer", "tilt_disk_target_in", "tilt_disk_target_out",
    "tilt_disk_contact_in", "bending_tilt_in", "bending_tilt_out", "tilt_smoothness_leaflet",
]
DRIVES_FIELDS = ("positions", "tilts_in", "tilts_out")


def kozlov_drives_protocol() -> dict:
    return {
        "kozlov": {**kozlov_protocol(), "steps": 0},
        "global_parameters": DRIVES_GP,
        "energy_modules": FD_MODULES,
        "modules": DRIVES_MODULES,
        "tilt_seed": 7,
        "tilt_scale": 0.1,
        "dtype": "float64",
        "package": "membrane_solver_tpu",
        "platform": "cpu",
    }


def drives_run() -> dict:
    """The drives at the precision this process runs.

    The inputs (positions, tilts_in, tilts_out) and, per module, the energy
    and its gradients in the same three fields, live rows, encoded with
    ``chip_smoke.encode_rows``.
    """
    import dataclasses

    import jax
    import numpy as np

    protocol = kozlov_drives_protocol()
    pkg, _build, _refinement = _jax()
    from chip_smoke import drives_setup, encode_rows
    from membrane_solver_tpu.device import geo as dgeo
    from membrane_solver_tpu.energy import get_module

    mesh = kozlov_minimizer().mesh
    drives_setup(mesh, protocol)
    p = pkg.Minimizer(mesh, quiet=True).problem()  # compiles the protocol's module list
    nv = p.n_vertices
    modules = {}
    for name in protocol["modules"]:
        module = get_module(name)
        maker = getattr(module, "make_energy", None)
        fn = maker(p.spec) if maker is not None else module.energy

        def f(*fields, fn=fn):
            st = dataclasses.replace(p.state, **dict(zip(DRIVES_FIELDS, fields)))
            geo = dgeo.triangle_geometry(st.positions, p.topo.tri_rows, p.topo.tri_valid)
            return fn(geo, st, p.topo, p.params)

        energy, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
            *(getattr(p.state, k) for k in DRIVES_FIELDS))
        modules[name] = {"energy": float(energy),
                         **{k: encode_rows(np.asarray(g, dtype=np.float64)[:nv])
                            for k, g in zip(DRIVES_FIELDS, grads)}}
    inputs = {k: np.asarray(getattr(p.state, k), dtype=np.float64)[:nv] for k in DRIVES_FIELDS}
    return {
        "n_vertices": nv,
        "n_triangles": p.n_tris,
        "inputs": {k: encode_rows(a) for k, a in inputs.items()},
        "modules": modules,
    }


def run_kozlov_drives() -> dict:
    import numpy as np

    child = start_float32_child("kozlov_L3_drives_f64_jax.json")  # runs beside float64
    rec = {"protocol": kozlov_drives_protocol(), **drives_run()}
    f32 = float32_result(child)
    from chip_smoke import decode_rows

    devs = {}
    for name, want in rec["modules"].items():
        got = f32["modules"][name]
        d = {"energy": abs(got["energy"] - want["energy"]) / abs(want["energy"])}
        for f in DRIVES_FIELDS:
            w, g = (decode_rows(r[f], rec["n_vertices"]) for r in (want, got))
            scale = float(np.max(np.abs(w)))
            d[f] = float(np.max(np.abs(g - w))) / scale if scale > 0 else 0.0
        devs[name] = d
    rec["float32_reference"] = {
        "package": "membrane_solver_tpu", "platform": "cpu", "dtype": "float32",
        "energies": {name: v["energy"] for name, v in f32["modules"].items()},
        "max_rel_dev_vs_float64": devs}
    return rec


# the local-interface family's drives on the kozlov L3 mesh: the four
# energies (the penalty, the soft rim matching with the disk group, the
# single-field bending-tilt, the inert legacy stub) and the constraints' tilt
# rows and enforcements, each mode, and the rigid disk's double fit
MATCH_GP = {
    "curved_local_interface_penalty_strength": 0.7,
    "rim_slope_match_strength": 0.6,
    "bending_modulus": 1.0,
    "spontaneous_curvature": 0.15,
    "tilt_leaflet_match_group": "rim",
    "rigid_disk_group": "rigid",
    "rigid_disk_radius": 1.0,
}
MATCH_ENERGIES = ["curved_local_interface_penalty", "rim_slope_match_out", "bending_tilt",
                  "mean_curvature_tilt"]
MATCH_CONSTRAINTS = ["tilt_leaflet_match_rim", "tilt_vector_match_rim",
                     "curved_local_interface_match", "rigid_disk"]
# per constraint: the global parameter of its mode and the modes held; the
# curved_local_interface_match modes compile anew (the mixed mode pairs other
# rows), the others switch the compiled static (``chip_smoke.static_variant``)
MATCH_MODES = {
    "tilt_leaflet_match_rim": ["tilt_leaflet_match_mode", ["average", "in_to_out", "out_to_in"]],
    "tilt_vector_match_rim": ["tilt_vector_match_mode", ["average", "rim_to_disk", "disk_to_rim"]],
    "curved_local_interface_match": ["curved_local_interface_match_mode",
                                     ["vector_average", "local_mixed_match_v1"]],
}
MATCH_FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")


def kozlov_match_drives_protocol() -> dict:
    return {
        "kozlov": {**kozlov_protocol(), "steps": 0},
        "global_parameters": MATCH_GP,
        "energy_modules": MATCH_ENERGIES,
        "constraint_modules": MATCH_CONSTRAINTS,
        "modes": MATCH_MODES,
        "groups": {"leaflet_match": "rim", "vector_match": "ring", "rigid_disk": "rigid"},
        "seed": 11,
        "z_scale": 0.02,
        "xy_scale": 0.005,
        "tilt_scale": 0.1,
        "rigid_seed": 13,
        "rigid_scale": 0.01,
        "dtype": "float64",
        "package": "membrane_solver_tpu",
        "platform": "cpu",
    }


def match_drives_run(refines: int = KOZLOV_REFINES) -> dict:
    """The match drives at the precision this process runs.

    The inputs (positions, tilts, tilts_in, tilts_out) and, per energy
    module, its value and gradients in the four fields; per constraint and
    mode, its dense tilt rows (one encoded (leaflet, row) block each) and the
    change its ``enforce_tilts`` makes to both leaflet fields; the rigid
    disk's enforcement, on the inputs offset by ``rigid_scale`` noise, as the
    change of the positions.  Arrays are live rows, ``chip_smoke.encode_rows``.
    """
    import dataclasses

    import jax
    import numpy as np

    protocol = kozlov_match_drives_protocol()
    pkg, _build, _refinement = _jax()
    from chip_smoke import encode_rows, match_drives_setup, match_problems, static_variant
    from membrane_solver_tpu.constraints import get_constraint
    from membrane_solver_tpu.device import geo as dgeo
    from membrane_solver_tpu.energy import get_module

    mesh = kozlov_minimizer(refines=refines).mesh
    match_drives_setup(mesh, protocol)
    problems = match_problems(pkg.Minimizer, mesh, protocol)
    p = next(iter(problems.values()))
    nv = p.n_vertices
    live = lambda a: np.asarray(a, dtype=np.float64)[:nv]  # noqa: E731
    energies = {}
    for name in protocol["energy_modules"]:
        module = get_module(name)
        maker = getattr(module, "make_energy", None)
        fn = maker(p.spec) if maker is not None else module.energy

        def f(*fields, fn=fn):
            st = dataclasses.replace(p.state, **dict(zip(MATCH_FIELDS, fields)))
            geo = dgeo.triangle_geometry(st.positions, p.topo.tri_rows, p.topo.tri_valid)
            return fn(geo, st, p.topo, p.params)

        energy, grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(
            *(getattr(p.state, k) for k in MATCH_FIELDS))
        energies[name] = {"energy": float(energy),
                          **{k: encode_rows(live(g)) for k, g in zip(MATCH_FIELDS, grads)}}
    constraints = {}
    for name, (_key, modes) in protocol["modes"].items():
        mod = get_constraint(name)
        for mode in modes:
            if name == "curved_local_interface_match":
                q = problems[mode]
                spec = q.spec
            else:
                q = p
                spec = static_variant(p.spec, f"constraint:{name}", mode)
            rows = np.asarray(mod.make_tilt_constraint_rows(spec)(q.state, q.topo, q.params))
            out = mod.make_enforce_tilts(spec)(q.state, q.topo, q.params)
            constraints[f"{name}/{mode}"] = {
                "rows": [[encode_rows(live(rows[k, leaf])) for leaf in range(2)]
                         for k in range(rows.shape[0])],
                **{f: encode_rows(live(getattr(out, f)) - live(getattr(q.state, f)))
                   for f in ("tilts_in", "tilts_out")}}
    rng = np.random.default_rng(protocol["rigid_seed"])
    moved = np.asarray(p.state.positions).copy()
    moved[:nv] += protocol["rigid_scale"] * rng.standard_normal((nv, 3))
    st = dataclasses.replace(p.state, positions=jax.numpy.asarray(moved))
    out = get_constraint("rigid_disk").make_enforce(p.spec)(st, p.topo, p.params)
    rigid = encode_rows(live(out.positions) - live(moved))
    return {
        "n_vertices": nv,
        "n_triangles": p.n_tris,
        "inputs": {k: encode_rows(live(getattr(p.state, k))) for k in MATCH_FIELDS},
        "energies": energies,
        "constraints": constraints,
        "rigid_disk": rigid,
    }


def run_kozlov_match_drives() -> dict:
    import numpy as np

    child = start_float32_child("kozlov_L3_match_drives_f64_jax.json")  # runs beside float64
    rec = {"protocol": kozlov_match_drives_protocol(), **match_drives_run()}
    f32 = float32_result(child)
    from chip_smoke import match_deviations

    rec["float32_reference"] = {
        "package": "membrane_solver_tpu", "platform": "cpu", "dtype": "float32",
        "energies": {name: v["energy"] for name, v in f32["energies"].items()},
        "max_rel_dev_vs_float64": match_deviations(rec, f32, np)}
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
    **{name: (lambda name=name: lane_run(LANE_PROTOCOLS[name]())) for name in LANE_PROTOCOLS},
    "kozlov_L3_drives_f64_jax.json": drives_run,
    "kozlov_L3_match_drives_f64_jax.json": match_drives_run,
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


# the two physical-edge lanes at L0 (two steps): JAX's own spread under 1e-15
# of z noise (ROADMAP C3), which bounds tests/test_torch_scaffold_trace.py
PHYSICAL_EDGE_L0_STEPS = 2


def physical_edge_L0_noise() -> dict:
    """Per L0 lane the clean and the noisy run's energies and accept flags, two steps each.

    The noise: ``numpy.random.default_rng(0)`` normals times 1e-15 on every
    vertex's z, in vertex-id order (``_torch_port_harness.jax_noise_state``'s).
    """
    import numpy as np

    out = {"steps": PHYSICAL_EDGE_L0_STEPS, "amplitude": 1e-15, "lanes": {}}
    for name, make in (("physical_edge", kozlov_physical_edge_protocol),
                       ("scaffold", kozlov_scaffold_protocol)):
        protocol = make()
        runs = {}
        for label, amp in (("clean", 0.0), ("noisy", 1e-15)):
            mn = kozlov_minimizer(protocol["global_parameters"], edits=protocol, refines=0)
            rng = np.random.default_rng(0)
            for vid in sorted(mn.mesh.vertices):
                mn.mesh.vertices[vid].position[2] += amp * rng.standard_normal()
            mn.invalidate()
            steps = [mn.minimize(1) for _ in range(PHYSICAL_EDGE_L0_STEPS)]
            runs[label] = {"energies": [float(r["energy"]) for r in steps],
                           "accepted": [bool(r["step_success"]) for r in steps]}
        runs["rel_spread"] = [abs(a - b) / abs(a) for a, b in
                              zip(runs["clean"]["energies"], runs["noisy"]["energies"])]
        out["lanes"][name] = runs
    return out


FIXTURES = {
    "kozlov_L3_f64_jax.json": run_kozlov,
    "physical_edge_L0_noise.json": physical_edge_L0_noise,
    "helfrich_cube_L5_f64_jax.json": run_vesicle,
    **{name: (lambda name=name: run_cli_fixture(name)) for name in CLI_PROTOCOLS},
    "kozlov_L3_thetaB_f64_jax.json": run_kozlov_thetaB,
    **{name: (lambda name=name: run_lane_fixture(name, LANE_PROTOCOLS[name]()))
       for name in LANE_PROTOCOLS},
    "kozlov_L3_drives_f64_jax.json": run_kozlov_drives,
    "kozlov_L3_match_drives_f64_jax.json": run_kozlov_match_drives,
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
