#!/usr/bin/env python3
"""Record the JAX package's reference trajectories for the PyTorch port.

Runs the protocols below with ``membrane_solver_tpu`` on the CPU in float64
and writes one JSON file each to ``tests/fixtures/torch_port/``:

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

``kozlov_L3_J0_fit_f64_jax.json`` (``lane_run``): the kozlov protocol with
the last per-module modes (``J0_FIT_GP``: the inner assume-J0 disk rows,
the outer physical-disk base-term region, the legacy theta_B contact
penalty; ``J0_FIT_DEFINITIONS``: the rim ring's ``pin_to_circle`` fit and
the disk's ``pin_to_plane`` slide, set on the presets' definitions by
``chip_smoke.lane_edits``); per step also theta_B after the closed-form
update, the fitted rim circle and the slide plane offset (``fits``), in
``float32_reference`` too.  ``J0_fit_noise.json`` (``j0_fit_noise``): that
lane, and the same with a spontaneous curvature of 1, at L0 and L3, two
steps, clean and under 1e-15 of z noise.

``kozlov_L3_mode_drives_f64_jax.json`` (``mode_drives_run``): four problems
(``MODE_PROBLEMS``) compiled from the kozlov L3 mesh with seeded heights and
tilts (``chip_smoke.mode_drives_setup``): per problem the listed energies'
values and gradients (sampled rows and norms, ``chip_smoke.sketch``), the
divergence cap's capped triangles, the pin constraints' enforcement and
local normals; the closed-form theta_B and the Gauss-Bonnet invariant of
the seeded state; its ``float32_reference`` holds the float32 deviations
per item (``chip_smoke.mode_deviations``).

``cube_cli_f32_pre_u_jax.json.gz`` (``c4_pre_u_state``, gzipped): the JAX
package's float32 host mesh just before the cube recipe's last ``u``
(command index 24, 12,290 vertices), with the connectivity digests after
that ``u`` and the state's smallest first-pass Delaunay margin (ROADMAP C4).

``kozlov_L3_sweep_f64_jax.json`` (``sweep_run``): the kozlov protocol
(three refinements, five ``minimize(1)``), then ``parallel.sweep.run_sweep``
on the problem it leaves with eight members (``chip_smoke.sweep_members``:
member m's positions times 1 + 0.001 m, ``tilt_modulus_in`` times 1 + 0.1 m,
``tilt_thetaB_value`` plus 0.01 m), five steps at step size 1e-3, default
options (no tilt relax: the JAX sweep passes no ``tilt_inner_iters``).
Per member the final and accepted energies, the gradient norm, the step
size, the accept flag, the iterations and a sketch of the final positions
(512 sampled rows and the norm, ``chip_smoke.sweep_record``); its
``float32_reference`` holds the float32 run's energies, flags and
iterations and their largest relative deviation from float64.

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
    (``trace_z``); on the physical-edge lanes the compiled shells; with
    ``record_fits``, per step theta_B, the fitted rim circle and the slide
    plane offsets (``fits``, :func:`jax_fit_record`).
    """
    import jax

    solves = kkt_recorder()
    steps = step_recorder()
    mn = kozlov_minimizer(protocol["global_parameters"], edits=protocol)
    energy0 = float(mn.compute_energy())
    breakdown0 = {k: float(v) for k, v in mn.compute_energy_breakdown().items()}
    energies, accepted, step_sizes, finite, lam_max, breakdowns = [], [], [], [], [], []
    relax_counts, trace_z, fits = [], [], []
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
        if protocol.get("record_fits"):
            fits.append(jax_fit_record(mn))
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
    if fits:
        out["fits"] = fits
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
    if "fits" in f32:
        rec["float32_reference"]["fits"] = f32["fits"]
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


# the kozlov lane with the last per-module modes: the inner leaflet's
# assume-J0 preset rows (the disk) and the outer leaflet's physical-disk
# base-term region (r <= the builder's disk radius) take a zero Helfrich
# base term, the legacy theta_B contact penalty moves theta_B to its closed
# form at the start of every iteration, the rim ring's pin_to_circle fits
# its circle's center (its normal and radius given) and the disk's
# pin_to_plane slides along its normal through the disk's centroid
J0_FIT_GP = {
    "bending_tilt_assume_J0_presets_in": ["disk"],
    "bending_tilt_base_term_region_mode": "physical_disk_split_v1",
    "bending_tilt_base_term_region_radius": 1.0,  # kozlov_1disk's disk_radius
    "tilt_thetaB_contact_penalty_mode": "legacy",
}
J0_FIT_DEFINITIONS = {"rim": {"pin_to_circle_mode": "fit"}, "disk": {"pin_to_plane_mode": "slide"}}
# a spontaneous curvature of 1 in both leaflets (tests/test_gp_option_parity.py's,
# which makes the kept base term order one) is not in the lane: from the flat
# start the JAX package's own energies then move by 5-14% under 1e-15 of
# height noise (j0_fit_noise), against 1e-4 without it
J0_FIT_C0 = {"spontaneous_curvature_in": 1.0, "spontaneous_curvature_out": 1.0}


def kozlov_J0_fit_protocol() -> dict:
    return {**kozlov_protocol(), "global_parameters": {**BENCH_GP, **J0_FIT_GP},
            "definition_options": J0_FIT_DEFINITIONS, "record_fits": True}


def jax_fit_record(mn) -> dict:
    """theta_B, the fitted rim circle (center, radius) and the slide plane offsets, JAX package."""
    import numpy as np

    from membrane_solver_tpu.constraints import pin_to_circle, pin_to_plane

    p = mn.problem()
    ex = p.topo.extras
    out = {"thetaB": float(mn.global_params.get("tilt_thetaB_value"))}
    if np.any(np.asarray(ex["constraint:pin_to_circle/m_valid"])):
        _n, center, radius = pin_to_circle._group_circles(p.state.positions, p.topo)
        out["circle_center"] = np.asarray(center, dtype=float).tolist()
        out["circle_radius"] = np.asarray(radius, dtype=float).tolist()
    if np.any(np.asarray(ex["constraint:pin_to_plane/mode"]) != pin_to_plane.MODE_FIXED):
        normals, points = pin_to_plane._group_planes(p.state.positions, p.topo)
        out["plane_offset"] = np.sum(np.asarray(normals * points, dtype=float), axis=1).tolist()
    return out


# the parameter sweep on the kozlov lane after its protocol's five steps:
# eight members (chip_smoke.sweep_members), five steps of the sweep's block
SWEEP_MEMBERS = 8
SWEEP_STEPS = 5
SWEEP_STEP_SIZE = 1e-3


def kozlov_sweep_protocol() -> dict:
    return {
        "kozlov": kozlov_protocol(),
        "members": SWEEP_MEMBERS,
        "dilation": 1e-3,  # member m: positions x (1 + dilation m)
        "modulus_step": 0.1,  # tilt_modulus_in x (1 + modulus_step m)
        "thetaB_step": 0.01,  # tilt_thetaB_value + thetaB_step m
        "steps": SWEEP_STEPS,
        "step_size": SWEEP_STEP_SIZE,
        "options": "default MinimizeOptions (gradient descent, adaptive step)",
        "sample_rows": 512,
        "sample_seed": 0,
        "dtype": "float64",
        "package": "membrane_solver_tpu",
        "platform": "cpu",
    }


def sweep_run() -> dict:
    """The sweep protocol at the precision this process runs (``chip_smoke.sweep_record``)."""
    import numpy as np

    from chip_smoke import sweep_members, sweep_record
    from membrane_solver_tpu.parallel.sweep import run_sweep

    protocol = kozlov_sweep_protocol()
    mn = kozlov_minimizer()
    for _ in range(STEPS):
        mn.minimize(1)
    problem = mn.problem()
    n = len(mn.mesh.vertices)
    params, positions = sweep_members(protocol, np.asarray(problem.state.positions),
                                      problem.params)
    states, _ss, stats = run_sweep(problem, params, protocol["steps"],
                                   step_size=protocol["step_size"], member_positions=positions)
    return sweep_record(protocol, {k: np.asarray(getattr(stats, k)) for k in
                                   ("energy", "accepted_energy", "grad_norm", "step_size",
                                    "step_success", "iterations")},
                        np.asarray(states.positions)[:, :n])


def run_kozlov_sweep() -> dict:
    """The float64 sweep here, the float32 one in a child beside it."""
    child = start_float32_child("kozlov_L3_sweep_f64_jax.json")
    rec = {"protocol": kozlov_sweep_protocol(), **sweep_run()}
    f32 = float32_result(child)
    devs = [abs(a - b) / abs(b) for a, b in zip(f32["energy"], rec["energy"], strict=True)]
    rec["float32_reference"] = {
        "package": "membrane_solver_tpu", "platform": "cpu", "dtype": "float32",
        **{k: f32[k] for k in ("energy", "accepted_energy", "step_success", "iterations")},
        "max_rel_dev_vs_float64": max(devs)}
    return rec


# the step-by-step kozlov lanes with their accept flags
LANE_PROTOCOLS = {
    "kozlov_L3_reduced_f64_jax.json": kozlov_reduced_protocol,
    "kozlov_L3_smooth_f64_jax.json": kozlov_smooth_protocol,
    "kozlov_L3_free_disk_f64_jax.json": kozlov_free_disk_protocol,
    "kozlov_L3_interface_f64_jax.json": kozlov_interface_protocol,
    "kozlov_L3_physical_edge_f64_jax.json": kozlov_physical_edge_protocol,
    "kozlov_L3_scaffold_f64_jax.json": kozlov_scaffold_protocol,
    "kozlov_L3_J0_fit_f64_jax.json": kozlov_J0_fit_protocol,
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


# the per-module modes on the kozlov L3 mesh, one evaluation each, on seeded
# heights and leaflet tilts: four problems compiled from one host mesh, each
# with a set of modes that act on different modules.  The divergence cap's
# bands (rim |r - 1| <= 0.25, near band (1.25, 2]) bind on the seeded tilts.
# Per problem the listed energies, the pin constraints' enforcement and
# normals; the float32 relax of each problem runs the frozen-tilt kernel only
# where ``kernel_in_relax`` (JAX's gate); then the legacy penalty's
# closed-form theta_B and the Gauss-Bonnet invariant of the seeded state
MODE_GP = {"benchmark_disk_radius": 1.0, "benchmark_lambda_value": 0.25}
_FREE_CIRCLE = {"pin_to_circle_radius": None}
MODE_PROBLEMS = {
    "cap": {
        "global_parameters": {
            "bending_tilt_in_update_mode": "outer_near_divergence_cap_v1",
            "bending_tilt_base_term_reference_mode_out": "flat_reference_zero_J0",
            "tilt_thetaB_contact_work_mode": "field_linear",
            "pin_to_plane_mode": "slide",
        },
        "definition_options": {
            "rim": {"pin_to_circle_mode": "slide", **_FREE_CIRCLE},
            "outer_rim": {"pin_to_circle_mode": "slide", **_FREE_CIRCLE},
        },
        "energies": ["bending_tilt_in", "bending_tilt_out", "tilt_thetaB_contact_in"],
        "kernel_in_relax": False,
    },
    "radial": {
        "global_parameters": {
            "bending_tilt_in_update_mode": "radial_cross_term_off_v1",
            "bending_tilt_base_term_region_mode": "physical_disk_split_v1",
            "bending_tilt_base_term_region_radius": 1.0,
            "tilt_thetaB_contact_penalty_mode": "legacy",
            "pin_to_plane_mode": "fit",
        },
        "definition_options": {
            "rim": {"pin_to_circle_mode": "fit", "pin_to_circle_normal": None, **_FREE_CIRCLE},
            "outer_rim": {"pin_to_circle_mode": "fit", **_FREE_CIRCLE},
        },
        "energies": ["bending_tilt_in", "bending_tilt_out", "tilt_thetaB_contact_in"],
        "kernel_in_relax": False,
    },
    "diagonal": {
        "global_parameters": {
            "bending_tilt_base_term_reference_mode_in": "flat_reference_zero_J0",
            "bending_tilt_assume_J0_presets_out": ["disk", "rim"],
            "bending_tilt_assume_J0_presets_radius_max_out": 0.75,
            "tilt_mass_mode": "diagonal",
        },
        "energies": ["bending_tilt_in", "bending_tilt_out", "tilt_in", "tilt_out"],
        "kernel_in_relax": False,
    },
    "disk_only": {
        "global_parameters": {
            "bending_tilt_base_term_region_mode": "disk_only_base_term_v1",
            "bending_tilt_base_term_region_radius": 1.0,
        },
        "energies": ["bending_tilt_in", "bending_tilt_out"],
        "kernel_in_relax": True,
    },
}


def kozlov_mode_drives_protocol(refines: int = KOZLOV_REFINES) -> dict:
    return {
        "kozlov": {**kozlov_protocol(), "steps": 0, "refines": refines},
        "global_parameters": MODE_GP,
        "problems": MODE_PROBLEMS,
        "thetaB_problem": "radial",
        "seed": 17,
        "z_scale": 0.02,
        "tilt_scale": 0.1,
        "sample_seed": 3,
        "sample_rows": 512,
        "relax_iters": 3,
        "dtype": "float64",
        "package": "membrane_solver_tpu",
        "platform": "cpu",
    }


def mode_drives_run(refines: int = KOZLOV_REFINES) -> dict:
    """The mode drives at the precision this process runs (``chip_smoke.port_mode_record``'s format).

    Per problem: each listed energy module's value and its gradients in the
    positions and both leaflet tilts (sketched: sampled rows, L2 norm, max
    |entry|), the divergence cap's capped triangles, the pin constraints'
    position changes under ``enforce`` and their local normals; then the
    closed-form theta_B and the Gauss-Bonnet invariant of the seeded host
    state.
    """
    import dataclasses

    import jax
    import numpy as np

    protocol = kozlov_mode_drives_protocol(refines)
    pkg, _build, _refinement = _jax()
    from chip_smoke import (
        MODE_FIELDS,
        encode_rows,
        mode_drives_setup,
        mode_problem_setup,
        sample_rows,
        sketch,
    )
    from membrane_solver_tpu.constraints import get_constraint
    from membrane_solver_tpu.core.parameters import ParameterResolver
    from membrane_solver_tpu.device import geo as dgeo
    from membrane_solver_tpu.device.tilt_ops import p1_triangle_divergence
    from membrane_solver_tpu.energy import bending_tilt_leaflet as bt
    from membrane_solver_tpu.energy import get_module, tilt_thetaB_contact_in
    from membrane_solver_tpu.runtime.diagnostics.gauss_bonnet import gauss_bonnet_invariant

    mesh = kozlov_minimizer(refines=refines).mesh
    snapshot = mode_drives_setup(mesh, protocol)
    rec = {"problems": {}}
    for name, prob in protocol["problems"].items():
        mode_problem_setup(mesh, protocol, snapshot, name)
        p = pkg.Minimizer(mesh, quiet=True).problem()
        nv = p.n_vertices
        rows = sample_rows(protocol, nv)
        live = lambda a: np.asarray(a, dtype=np.float64)[:nv]  # noqa: E731
        if "inputs" not in rec:
            rec.update(n_vertices=nv, n_triangles=p.n_tris,
                       inputs={f: sketch(live(getattr(p.state, f)), rows) for f in MODE_FIELDS})
        out = {"energies": {}, "enforce": {}, "normals": {}}
        for mod_name in prob["energies"]:
            module = get_module(mod_name)
            maker = getattr(module, "make_energy", None)
            fn = maker(p.spec) if maker is not None else module.energy

            def f(*fields, fn=fn):
                st = dataclasses.replace(p.state, **dict(zip(MODE_FIELDS, fields)))
                geo = dgeo.triangle_geometry(st.positions, p.topo.tri_rows, p.topo.tri_valid)
                return fn(geo, st, p.topo, p.params)

            e, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
                *(getattr(p.state, k) for k in MODE_FIELDS))
            out["energies"][mod_name] = {"energy": float(e), **{
                k: sketch(live(g), rows) for k, g in zip(MODE_FIELDS, grads)}}
        if prob["global_parameters"].get("bending_tilt_in_update_mode") == (
                "outer_near_divergence_cap_v1"):
            pos = p.state.positions
            div, _a, _g = p1_triangle_divergence(pos, p.state.tilts_in, p.topo.tri_rows,
                                                 p.topo.tri_valid)
            center = p.topo.extras["energy:bending_tilt_in/update_center"].astype(pos.dtype)
            capped = bt._apply_divergence_cap(-div, *bt._tri_cap_masks(pos, p.topo, p.params,
                                                                       center))
            out["capped"] = int(np.sum(np.asarray(capped != -div) & np.asarray(p.topo.tri_valid)))
        for con in ("pin_to_plane", "pin_to_circle"):
            mod = get_constraint(con)
            moved = mod.enforce(p.state, p.topo, p.params, context="minimize")
            out["enforce"][con] = encode_rows(live(moved.positions) - live(p.state.positions))
            normals = live(mod.local_constraint_normals(p.state, p.topo, p.params))
            out["normals"][con] = [encode_rows(normals[:, k]) for k in range(normals.shape[1])]
        rec["problems"][name] = out
    gp = mesh.global_parameters
    mode_problem_setup(mesh, protocol, snapshot, protocol["thetaB_problem"])
    tilt_thetaB_contact_in.update_scalar_params(mesh, gp, ParameterResolver(gp))
    rec["thetaB_update"] = float(gp.get("tilt_thetaB_value"))
    g, k_int, b_total, _per_loop = gauss_bonnet_invariant(mesh)
    rec["gauss_bonnet"] = {"G": g, "K_int": k_int, "B": b_total}
    return rec


def run_kozlov_mode_drives() -> dict:
    child = start_float32_child("kozlov_L3_mode_drives_f64_jax.json")  # runs beside float64
    rec = {"protocol": kozlov_mode_drives_protocol(), **mode_drives_run()}
    f32 = float32_result(child)
    from chip_smoke import mode_deviations

    devs = mode_deviations(rec, f32)
    devs.pop("inputs")
    rec["float32_reference"] = {"package": "membrane_solver_tpu", "platform": "cpu",
                                "dtype": "float32", "max_rel_dev_vs_float64": devs}
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


# ROADMAP C4: the cube recipe's float32 state just before its last ``u``
# (command index 24, 12,290 vertices), as the JAX package's float32 run
# leaves it; written gzipped (``C4_FIXTURE``)
C4_COMMAND = 24
C4_FIXTURE = "cube_cli_f32_pre_u_jax.json.gz"


def c4_pre_u_state() -> dict:
    """The JAX package's cube recipe, at the precision this process runs, up to the last ``u``.

    Returns the host mesh before that ``u`` (``mesh``, the JAX package's
    ``mesh_to_dict``), the connectivity digest after the ``u`` in the run
    itself and after a ``u`` from the mesh reloaded from that dict (the
    state the port starts from), the first-pass Delaunay margins' smallest
    size (``chip_smoke.flip_margins``) and the command context's arguments.
    """
    import tempfile

    import numpy as np

    pkg, _build, _refinement = _jax()
    from chip_smoke import connectivity_digest, flip_margins
    from membrane_solver_tpu.commands import CommandContext, execute_command_line
    from membrane_solver_tpu.geometry.io_writers import mesh_to_dict
    from membrane_solver_tpu.runtime.steppers import make_stepper

    protocol = cube_cli_protocol()

    def context(mesh):
        gp = mesh.global_parameters
        mn = pkg.Minimizer(mesh, stepper=make_stepper("gd"),
                           step_size=float(gp.get("step_size", 1e-3)), tol=1e-6, quiet=True)
        return CommandContext(mesh=mesh, minimizer=mn, stepper=mn.stepper)

    with tempfile.TemporaryDirectory() as tmp:
        mesh = pkg.parse_geometry(pkg.load_data(mesh_path(protocol, Path(tmp))))
    ctx = context(mesh)
    for cmd in protocol["commands"][:C4_COMMAND]:
        execute_command_line(ctx, cmd)
        ctx.sync_mesh()
    data = json.loads(json.dumps(mesh_to_dict(ctx.mesh)))
    margins = np.array(list(flip_margins(ctx.mesh).values()))
    execute_command_line(ctx, protocol["commands"][C4_COMMAND])
    ctx.sync_mesh()
    reloaded = context(pkg.parse_geometry(json.loads(json.dumps(data))))
    execute_command_line(reloaded, protocol["commands"][C4_COMMAND])
    reloaded.sync_mesh()
    return {"command": C4_COMMAND, "mesh": data,
            "n_vertices": len(ctx.mesh.vertices), "n_facets": len(ctx.mesh.facets),
            "digest_after_u": connectivity_digest(ctx.mesh),
            "digest_after_u_reloaded": connectivity_digest(reloaded.mesh),
            "candidate_edges": int(margins.size),
            "smallest_abs_margin": float(np.min(np.abs(margins))),
            "flips_in_first_pass": int(np.sum(margins > 0.0))}


def run_c4_pre_u() -> dict:
    rec = float32_child(C4_FIXTURE)
    rec["protocol"] = {**cube_cli_protocol(), "dtype": "float32", "stop_before": C4_COMMAND}
    return rec


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
    "kozlov_L3_mode_drives_f64_jax.json": mode_drives_run,
    C4_FIXTURE: c4_pre_u_state,
    "kozlov_L3_sweep_f64_jax.json": sweep_run,
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


J0_FIT_NOISE_STEPS = 2


def j0_fit_noise() -> dict:
    """The J0-fit lane's own spread in the JAX package: clean and noisy runs at L0 and at L3.

    Per variant (the lane, and the lane with ``J0_FIT_C0``) and refinement
    level, two ``minimize(1)`` from the clean start and from one with 1e-15
    of z noise (``_torch_port_harness.jax_noise_state``'s): the energies,
    accept flags and theta_B of each, and per step the energies' and
    theta_B's relative spread.  The clean runs also hold, per step, the
    fitted rim circle and slide plane (``fits``, :func:`jax_fit_record`):
    the L0 lane's is the JAX run ``tests/test_torch_thetaB_legacy.py``
    holds the port's against.
    """
    import numpy as np

    protocol = kozlov_J0_fit_protocol()
    out = {"steps": J0_FIT_NOISE_STEPS, "amplitude": 1e-15, "levels": {}}
    for variant, gp in (("lane", protocol["global_parameters"]),
                        ("spontaneous_curvature_1", {**protocol["global_parameters"],
                                                     **J0_FIT_C0})):
        for refines in (0, KOZLOV_REFINES):
            runs = {}
            for label, amp in (("clean", 0.0), ("noisy", 1e-15)):
                mn = kozlov_minimizer(gp, edits=protocol, refines=refines)
                rng = np.random.default_rng(0)
                for vid in sorted(mn.mesh.vertices):
                    mn.mesh.vertices[vid].position[2] += amp * rng.standard_normal()
                mn.invalidate()
                steps, thetas, fits = [], [], []
                for _ in range(J0_FIT_NOISE_STEPS):
                    steps.append(mn.minimize(1))
                    thetas.append(float(mn.global_params.get("tilt_thetaB_value")))
                    fits.append(jax_fit_record(mn))
                runs[label] = {"energies": [float(r["energy"]) for r in steps],
                               "accepted": [bool(r["step_success"]) for r in steps],
                               "thetaB": thetas}
                if amp == 0.0:
                    runs[label]["fits"] = fits
            for key in ("energies", "thetaB"):
                runs[f"rel_spread_{key}"] = [abs(a - b) / abs(a) for a, b in
                                             zip(runs["clean"][key], runs["noisy"][key])]
            out["levels"][f"{variant} L{refines}"] = runs
    return out


FIXTURES = {
    "kozlov_L3_f64_jax.json": run_kozlov,
    "J0_fit_noise.json": j0_fit_noise,
    "physical_edge_L0_noise.json": physical_edge_L0_noise,
    "helfrich_cube_L5_f64_jax.json": run_vesicle,
    **{name: (lambda name=name: run_cli_fixture(name)) for name in CLI_PROTOCOLS},
    "kozlov_L3_thetaB_f64_jax.json": run_kozlov_thetaB,
    **{name: (lambda name=name: run_lane_fixture(name, LANE_PROTOCOLS[name]()))
       for name in LANE_PROTOCOLS},
    "kozlov_L3_drives_f64_jax.json": run_kozlov_drives,
    "kozlov_L3_match_drives_f64_jax.json": run_kozlov_match_drives,
    "kozlov_L3_mode_drives_f64_jax.json": run_kozlov_mode_drives,
    C4_FIXTURE: run_c4_pre_u,
    "kozlov_L3_sweep_f64_jax.json": run_kozlov_sweep,
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
        text = json.dumps(rec, indent=1) + "\n"
        if name.endswith(".gz"):
            import gzip

            (args.output_dir / name).write_bytes(gzip.compress(text.encode(), mtime=0))
            print(name, json.dumps({k: v for k, v in rec.items() if k != "mesh"}), flush=True)
            continue
        (args.output_dir / name).write_text(text)
        print(name, json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
