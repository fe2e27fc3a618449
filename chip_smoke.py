#!/usr/bin/env python3
"""Smoke run of the PyTorch port (membrane_solver_tpu_torch) on one NVIDIA GPU.

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No CUDA device -> exit 2 before anything else.
2. build: compiles the CUDA sources of ``membrane_solver_tpu_torch/csrc``
   (``frozen_tilt.cu``, ``tri_kernels.cu``, ``vertex_sum.cu``, which share
   ``vertex_sum.cuh`` and ``block_sum.cuh``) with nvcc, one process per
   source, all started together; prints the seconds taken and the ptxas
   report.
3. kernels: every kernel against its plain PyTorch twin on the card, on the
   kozlov L3 lane's topology (10,817 vertices, 21,504 triangles) and the
   vesicle lane's (12,290 / 24,576), both built as phases 4-7 build them:
   - the frozen-tilt entry point, float32, seeded vertex tilts, P1
     gradients and payload at T = 301 and on the kozlov L3 topology, energy
     alone and energy plus vertex gradients: energy to rel 1e-6, gradients
     to 5e-6 * max|g|;
   - the vertex-sum kernel, float32 and float64, widths 1 and 3, on the
     kozlov L3 corner CSR: equal to its twin bit for bit (the same
     additions in the same order);
   - the per-triangle kernels (surface, curvature forward and backward with
     per-triangle outputs), float32 and float64, on seeded
     triangles (T = 301) and on the vesicle lane's own triangles (its start
     positions plus a seeded 1e-3 perturbation), and the curvature data
     entry point and its backward (vertex sums) on both lanes: float32 to
     the JAX kernel tests' bounds (surface e rel 2e-6 / atol 1e-7, corner
     gradients rel 2e-5 / atol 1e-6, curvature and the masked divergence
     rel 5e-5 / atol 1e-5, curvature backward 5e-5 * max|g|), float64 to
     1e-12 * max(|want|, 1) (curvature backward 1e-11 * max|g|).  Curvature
     rows within 1e-6 of a Meyer branch tie (a cotangent at 0), and the
     vertex sums that include one, are left out: there the two sides may
     take different branches;
   - on the same three sets, float32 and float64, the surface and
     divergence whole calls: the surface energy (tension mask and sum in
     the kernel) alone and with its vertex gradient, the masked divergence
     and its tilt backward (the weighted vertex sum): energy to rel 2e-6
     (float32) / 1e-12 (float64), vertex gradients to 2e-5 / 1e-12 and the
     tilt backward to 5e-5 / 1e-12 of max|g|, the divergence to the
     per-triangle kernels' bounds;
   - determinism: two energy-plus-gradient calls of the frozen-tilt and
     the surface entry points, and two forward-plus-backward calls of
     ``curvature_data`` and of ``p1_triangle_divergence``, on the same
     inputs must give the same bits;
   - one such call of each of the four entry points under
     ``torch.profiler``: no index, scatter, gather, sort or reduction
     kernel of PyTorch's own may appear among its device operations;
   - timing, at the kozlov L3 lane's shapes, float32 (the rows that
     ``tools/time_torch_kernels.py`` also times on the vesicle lane and at
     float64): for every kernel, twin and
     caller, the device ms per call (``torch.profiler``'s device time of
     the operations one call issues, over 200 back-to-back calls), the
     event ms per call (CUDA events around 200 back-to-back calls), the
     host µs per call (the same loop, no sync) and the bound; the callers
     (a relax energy evaluation, an ``eval_grads``-style energy and vertex
     gradient, ``curvature_data`` forward, forward plus backward, the
     surface energy module forward plus backward, the bending-tilt
     divergence, forward plus tilt backward) also the median µs of one
     call followed by a device sync.
4. kozlov L3, float32: the kozlov coupled-tilt protocol that its fixture's
   ``protocol`` block records (meshgen ``kozlov_1disk`` with the bench
   global parameters -> three refinement rounds -> 10,817 vertices, 21,504
   triangles -> five ``minimize(1)`` calls), then ``minimize(2)`` as warm-up
   and ``minimize(10)`` timed.  Every energy must be finite and the last
   below the first.  Host syncs of one step are counted with
   ``torch.cuda.set_sync_debug_mode`` and listed by the source line that
   issued them.
5. kozlov L3, float64: the same protocol; its five energies must match the
   JAX package's recorded trajectory
   (``tests/fixtures/torch_port/kozlov_L3_f64_jax.json``) to rel 1e-8, and
   the float32 energies of phase 4 must lie within rel 2e-3 of them.  Then
   the per-triangle kernels, the surface and divergence whole calls and the
   curvature data against their twins, at float32 and float64 with phase
   3's tolerances, on this lane's own 21,504
   triangles as the run left them: one set per leaflet, with that leaflet's
   tilts and the ``tri_valid & tri_present`` mask its bending-tilt
   curvature call takes.
6. helfrich_cube L5, float32: the Helfrich vesicle protocol of
   ``helfrich_cube_L5_f64_jax.json`` (meshgen cube, surface + Helfrich
   bending, hard volume constraint -> polygonal refine and five triangle
   refines -> 12,290 vertices, 24,576 triangles -> five ``minimize(1)``
   calls at the adaptive step), then 2 warm-up and 10 timed steps.
7. helfrich_cube L5, float64: the same; rel 1e-8 against the JAX fixture,
   and phase 6's energies within rel 2e-3 of these.
8. cube_cli L5, float32: the command list of
   ``tests/fixtures/torch_port/cube_cli_L5_f64_jax.json`` (the recipe of
   ``meshes/cube.json``, ``g50; r; u; V2; ...; g200`` to 770 vertices; the
   stepper segment ``bfgs; g10; hessian 2; cg; g20; gd``; then ``r; u; V2;
   g20; r; u; V2; cg; g20; energy stats`` up to 12,290 vertices and 24,576
   triangles) through the port's command layer, in the command context
   that ``cli.make_context`` builds for ``-q --non-interactive -i
   meshes/cube.json --f32``.  Per command: the energy, the vertex and facet
   counts, the host seconds (a device sync on both sides), ms per step for
   ``g`` commands, and after each ``u`` a digest of the connectivity; then
   the host syncs of one more ``g1`` by source line.
9. cube_cli L5, float64: the same without ``--f32``; every energy within
   rel 1e-8 of the JAX fixture with equal vertex and facet counts, and
   phase 8's energies within rel max(2e-3, 2 x the JAX package's own
   float32 deviation on these commands, the fixture's
   ``float32_reference``: 2.34e-3) of these.  Near the recipe's minimum
   a float32 run's line searches can fail and its step size decay (the
   JAX package's does, at ``g200``), and it then falls behind on the L5
   extension.  Phase 8's connectivity after each ``u`` is printed beside
   this phase's.
    Phase 8 also holds its connectivity after each ``u`` against the JAX
    package's own float32 run (the fixture's ``float32_reference``
    digests) and prints whether they are equal.
10. the console entry: ``python -m membrane_solver_tpu_torch
    --non-interactive -q -i meshes/cube.json -o <tmp>`` in a subprocess, on
    the card (no ``--cpu``); it must exit 0, and the saved mesh, reloaded
    and evaluated by the port at float64 on the card, must be within rel
    1e-8 of the fixture's energy after the recipe (4.835205065742603).
11. square_to_circle L1, float32: the shape family's lane, the command list
    of ``tests/fixtures/torch_port/square_to_circle_L1_f64_jax.json``
    (meshgen ``square_to_circle`` at n = 56, 3,249 vertices and 6,272
    triangles, written to a JSON file and loaded by the CLI; its recipe
    ``g40; r; g40; u; V4; g60`` refines it to 12,769 vertices and 25,088
    triangles; ``surface`` at zero tension and ``line_tension`` on the
    boundary, under the hard ``global_area`` constraint, whose projection
    takes its area and gradient from the surface whole call) through the
    command layer as phases 8-9 run theirs, with the same per-command
    lines.
12. square_to_circle L1, float64: the same; every energy within rel 1e-8 of
    the fixture with equal counts, phase 11's within rel max(2e-3, 2 x the
    JAX package's own float32 deviation) of these.  Then, on this lane's
    12,769 vertices and 25,088 triangles as the run left them, the area
    constraints' entry ``surface_energy_and_gradient`` against its twin at
    the lane's own tension (``surface``, zero here) and at unit tension
    (``global_area``), float32 and float64, with phase 3's whole-call
    bounds, and phase 3's tri-kernel checks on the same triangles scaled
    to unit mean edge length.

13. rect_tilt_source L0, float32: the single-field tilt lane, the command
    list of ``tests/fixtures/torch_port/rect_tilt_source_L0_f64_jax.json``
    (meshgen ``rect_tilt_source`` at nx = 160, ny = 64: 10,465 vertices and
    20,480 right isosceles triangles on the builder's 5 x 2 sheet, a unit
    tilt held on one edge; ``surface`` at zero tension, ``tilt`` and
    ``tilt_smoothness``; its recipe ``g5``, nested tilt solve with 60 inner
    CG steps, as five ``g1``) through the command layer as phases 8-9 run
    theirs, with the same per-command lines, then a ``g1 split`` line: the
    host seconds of one more ``g1``, of one ``minimize(1)`` and of the
    ``g`` command's host collision scan, each synced.
14. rect_tilt_source L0, float64: the same; every energy within rel 1e-8 of
    the fixture with equal counts, phase 13's within rel max(2e-3, 2 x the
    JAX package's own float32 deviation) of these.  The curvature data's
    backward must not launch on either run (the smoothness term takes its
    cotangents on detached positions).  Then phase 3's tri-kernel checks,
    float32 and float64, on the sheet's triangles as the run left them
    (the flat sheet's right angles make nearly every row a Meyer branch
    tie, which the checks leave out and count) and on the same triangles
    perturbed by 1e-3.
15. kozlov L3 theta_B scan, float64 then float32: phase 5's (phase 4's)
    minimizer, back at the state its five protocol steps left (the saved
    state of its determinism check; no second refinement), with the scan
    parameters of ``tests/fixtures/torch_port/kozlov_L3_thetaB_f64_jax.json``
    (a scan every iteration, delta 0.01) and one ``minimize(3)``: relax ->
    scan -> step each iteration.  Per scan, the three candidates' energies
    beside the reference's and the selected theta_B, which must equal the
    fixture's (float64) or the JAX package's own float32 selections
    (float32); every candidate energy and the final one within rel 1e-8 of
    the fixture (float64) or within rel max(2e-3, 2 x the JAX package's own
    float32 deviation) of the float64 run (float32); the ``compile_state``
    calls during the call (the minimize-entry enforcement's recompile, as
    in the JAX package, and none after it: a scan's theta_B write
    refreshes the parameters only); the scans' host seconds.
16. kozlov L3 reduced, float64: the protocol of
    ``tests/fixtures/torch_port/kozlov_L3_reduced_f64_jax.json`` (the kozlov
    protocol of phases 4-5 with ``line_search_reduced_energy`` on, its
    default 10 inner steps per trial, and ``rim_slope_match_mode``
    ``shared_rim_staggered_v1``; five ``minimize(1)``): every Armijo trial
    and the baseline re-relax both leaflet tilts before they are scored.
    Energies within rel 1e-8 of the fixture and the fixture's accept flag
    at every step; then ``minimize(5)`` timed after two warm-up steps
    (ms per step, line-search trials per step, accepted steps).
17. kozlov L3 reduced, float32: the same; energies within rel max(2e-3, 2
    x the JAX package's own float32 deviation, the fixture's
    ``float32_reference``) of phase 16's.  The frozen-tilt kernel's
    launches per ``minimize`` step (both variants) must exceed phase 4's:
    here it runs inside every trial's relax.  A ``[16-17 ...]`` line gives
    the two phases' seconds.

Every lane phase (4-9, 11-17) also checks determinism: from the state its
protocol leaves (phases 4-7 and 16-17: the five steps; phases 8-9 and
11-14: the command list; phase 15: its ``minimize(3)``), it saves the state, runs
``minimize(2)`` (``g2`` through the command layer), takes a sha256 of the
positions, the tilts and the energies, restores the state and runs again;
a ``[... determinism]`` line prints both digests, and unequal digests fail
the run.  The last line before the kernels line gives the whole run's
seconds.

Phases 4-9 and 11-17 each drive one path with every kernel launch counter
set to 0 just before and read just after; a kernel of that path that was
never launched fails the run (the frozen-tilt entry point, both variants,
lies on the float32 kozlov paths only, phases 4, 15 and 17; the surface
energy, both variants, and the vertex sum on all thirteen; the curvature
data forward on phases 4-9 and 13-17 (on the cube paths through ``energy
stats``), its backward on phases 4-7 and 15-17; the divergence forward on
the kozlov paths; its tilt backward on none, so phase 3 alone launches it).

The line before the last is a JSON object ``{"kernels": [...]}``: per entry
point, its launches over phases 4-9 and 11-17, its largest error against its twin,
and phase 3's device ms per call (``ms``), its twin's (``plain_ms``), the
bound, and, for the vertex sum, ``index_add_``'s (``library_ms``).  The
last line is ``{"ok": true, "device": {...}}``.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
KOZLOV_FIXTURE = FIXTURES / "kozlov_L3_f64_jax.json"
VESICLE_FIXTURE = FIXTURES / "helfrich_cube_L5_f64_jax.json"
CUBE_CLI_FIXTURE = FIXTURES / "cube_cli_L5_f64_jax.json"
SQUARE_FIXTURE = FIXTURES / "square_to_circle_L1_f64_jax.json"
RECT_FIXTURE = FIXTURES / "rect_tilt_source_L0_f64_jax.json"
THETAB_FIXTURE = FIXTURES / "kozlov_L3_thetaB_f64_jax.json"
REDUCED_FIXTURE = FIXTURES / "kozlov_L3_reduced_f64_jax.json"
CSRC = "membrane_solver_tpu_torch/csrc/"
# entry point -> (source, the TPU kernel or JAX function it replaces, the
# name of its timing rows, its launch counter)
KERNELS = {
    # the Pallas _fwd_kernel and _bwd_kernel, both behind the pallas_call at
    # frozen_tilt.py:186
    "frozen_tilt_energy": ("frozen_tilt.cu", "pallas_kernels/frozen_tilt.py:83",
                           "frozen_tilt_energy", "frozen_tilt.energy"),
    "frozen_tilt_energy_grad": ("frozen_tilt.cu", "pallas_kernels/frozen_tilt.py:111",
                                "frozen_tilt_energy_grad", "frozen_tilt.energy_grad"),
    # no Pallas kernel: the JAX package's segment sums (geo.scatter_add_rows)
    "vertex_sum": ("vertex_sum.cuh", "device/geo.py:95", "vertex_sum",
                   "vertex_sum.vertex_sum"),
    # _surface_kernel with the tension mask, the energy sum and the scatter
    # of its corner gradients
    "tri_surface_energy": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:80", "surface_energy",
                           "tri_kernels.surface_energy"),
    "tri_surface_energy_grad": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:80",
                                "surface_energy_grad", "tri_kernels.surface_energy_grad"),
    # _curvature_kernel with the stock geo.curvature_data scatter after it
    "tri_curvature_data": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:143",
                           "curvature_data", "tri_kernels.curvature_data"),
    # the backward JAX takes for curvature_corners_pallas (stock AD)
    "tri_curvature_data_bwd": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:193",
                               "curvature_data_bwd", "tri_kernels.curvature_data_bwd"),
    # _p1_div_kernel with the stock p1_triangle_divergence masks
    "tri_p1_div": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:228", "p1_div",
                   "tri_kernels.p1_div"),
    # the backward JAX takes for the divergence in the tilts (stock AD); no
    # lane path differentiates the tilts, so phase 3 alone launches it
    "tri_p1_div_bwd": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:262", "p1_div_bwd",
                       "tri_kernels.p1_div_bwd"),
}
# the per-entry-point error keys of phases 3 and 5
ERRORS = {"frozen_tilt_energy": ("ft_energy",), "frozen_tilt_energy_grad": ("ft_energy", "ft_grad"),
          "vertex_sum": ("vertex_sum",),
          "tri_surface_energy": ("surface_energy", "surface_fwd"),
          "tri_surface_energy_grad": ("surface_energy", "surface_grad", "surface_fwd"),
          "tri_curvature_data": ("curvature_data", "curvature_fwd"),
          "tri_curvature_data_bwd": ("curvature_data_bwd", "curvature_bwd"),
          "tri_p1_div": ("p1_div",), "tri_p1_div_bwd": ("p1_div_bwd",)}
# PyTorch's own kernels that the redesigned entry points must not issue
LIBRARY_KERNEL = re.compile(r"index|scatter|gather|sort|reduce", re.IGNORECASE)
OWN_KERNELS = ("frozen_tilt_kernel", "vertex_sum_kernel", "curvature_fwd_kernel",
               "curvature_bwd_kernel", "surface_kernel", "p1_div_kernel")

DEVICE = "cuda"
WARMUP_STEPS = 2
TIMED_STEPS = 10
REDUCED_TIMED_STEPS = 5  # phases 16-17: each step relaxes once per line-search trial

ENERGY_RTOL = 1e-6  # frozen-tilt kernel vs twin energy (f32 reduction order)
GRAD_RTOL = 5e-6  # frozen-tilt kernel vs twin gradient, relative to max|g|
F64_RTOL = 1e-8  # f64 trajectory vs the JAX fixture (CUDA scatter order)
F32_RTOL = 2e-3  # f32 vs f64 trajectory
CONSOLE_TIMEOUT_S = 300  # phase 10's subprocess
# per-triangle kernels vs twins: (rtol, atol) elementwise at float32 (the JAX
# kernel tests' bounds), rtol of max(|want|, 1) at float64
TK_F32 = {"e": (2e-6, 1e-7), "g": (2e-5, 1e-6), "curv": (5e-5, 1e-5)}
TK_F64 = 1e-12
TK_BWD = {"float32": 5e-5, "float64": 1e-11}  # of max|g|
# the surface and divergence whole calls: energy rel; vertex sums of max|g|
WC_ENERGY = {"float32": 2e-6, "float64": 1e-12}
WC_SURFACE_GRAD = {"float32": 2e-5, "float64": 1e-12}
WC_DIV_BWD = {"float32": 5e-5, "float64": 1e-12}
TIE = 1e-6  # |cot| below this: a Meyer branch tie


# The card's published peaks (H100 SXM data sheet: memory rate, float32 and
# float64 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Floating-point operations per triangle, counted from the CUDA sources and
# rounded up (the gradient row is the frozen-tilt gradient's own work, on top
# of the energy's).  Every kernel here is bound by bytes by a factor of ten or
# more, so these only need the right order.
FLOPS_PER_TRI = {
    "frozen_tilt_energy": 190,
    "frozen_tilt_grad": 270,
    "surface_energy": 30,
    "surface_grad": 45,
    "curvature_fwd": 140,
    "curvature_bwd": 320,
    "p1_div": 80,
    "p1_div_bwd": 18,
}


def bound_ms(moved_bytes: int, flops: float, dtype_name: str) -> tuple[float, str]:
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``, first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch) -> dict:
    smi_text = smi_line()
    print(smi_text, flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    say("1 device", name=repr(device["kind"]), count=device["count"],
        torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    return device


def phase_build(mods) -> None:
    from membrane_solver_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(*(m.KERNEL for m in mods))  # one nvcc per source, in parallel
    for m in mods:
        m.build()
    seconds = time.perf_counter() - t0
    say("2 build", seconds=f"{seconds:.3f}",
        libraries=",".join(m.KERNEL.library_path().name for m in mods))
    for m in mods:
        for ln in m.KERNEL.log().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                say("2 build ptxas", source=m.KERNEL.name, line=repr(ln.strip()))


LOOP = 200  # back-to-back calls per timing


def time_call(torch, fn, calls: int = LOOP, warmup: int = 5) -> dict:
    """Device and host time per call of ``fn`` over ``calls`` back-to-back calls.

    Inputs are prepared by the caller, outside the window.  Returns
    - ``event_ms``: CUDA events around the loop, divided by ``calls`` (the
      device's wall time per call; where the host is slower than the
      device this is the host's pace);
    - ``host_us``: ``time.perf_counter`` around the same loop, no sync;
    - ``device_ms``: the device time of the operations one call issues,
      summed from ``torch.profiler`` over a second loop (no host gaps);
    - ``ops_per_call`` and ``ops``: those operations, by name.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        raise RuntimeError("the profiler recorded no device-side operation")
    return {
        "event_ms": start.elapsed_time(end) / calls,
        "host_us": host_s * 1e6 / calls,
        "device_ms": sum(e.self_device_time_total for e in rows) / 1e3 / calls,
        "ops_per_call": sum(e.count for e in rows) / calls,
        "ops": {e.key: e.count / calls for e in rows},
    }


def synced_us(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Median host µs of one call followed by a device sync: what a caller that reads the result waits."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def device_ops(torch, fn) -> list:
    """Names of the device operations one call of ``fn`` issues (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


# ----------------------------------------------------------------------
# timing rows: (name, kind, fn, inputs and outputs' tensors, flops)
# ----------------------------------------------------------------------
CALLER_CALLS = 50  # caller-level loops issue several operations per call


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    if hasattr(out, "k_vecs"):  # CurvatureData
        return [out.k_vecs, out.vertex_areas, out.weights, out.corner_areas]
    return [out] if out is not None else []


def frozen_tilt_rows(torch, ft, topo, n_vertices: int) -> list:
    """(name, kind, fn, inputs, flops) for the frozen-tilt entry point, its twin and callers, float32.

    ``inputs`` are the function's own: the CSR counts only for the vertex
    sum, whose input it is (the entry point's gradient would need no CSR
    under another scatter design).
    """
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    rows = topo.tri_rows
    T = rows.shape[0]
    tin, tout, g, pay, k = _ft_inputs(torch, rows, n_vertices, 13)
    csr = topo.corner_csr()
    ws = ft.Workspace(T, rows.device)
    base = (tin, tout, rows, csr, g, pay, k)
    e_in = (tin, tout, rows, g, pay, k)
    corner = torch.randn((T, 3, 3), dtype=torch.float32, device=rows.device,
                         generator=torch.Generator(device=rows.device).manual_seed(13))
    flat_rows = rows.reshape(-1)
    out = torch.zeros((n_vertices, 3), dtype=torch.float32, device=rows.device)
    flops_e = FLOPS_PER_TRI["frozen_tilt_energy"] * T
    flops_g = flops_e + FLOPS_PER_TRI["frozen_tilt_grad"] * T

    def relax_energy():
        with torch.no_grad():
            return ft.frozen_tilt_energy(*base, ws)

    def eval_grads():
        a, b = tin.detach().requires_grad_(True), tout.detach().requires_grad_(True)
        return torch.autograd.grad(ft.frozen_tilt_energy(a, b, *base[2:], ws), (a, b))

    return [
        ("frozen_tilt_energy", "kernel", lambda: ft.launch(*base, ws, grad=False), e_in, flops_e),
        ("frozen_tilt_energy_grad", "kernel", lambda: ft.launch(*base, ws, grad=True), e_in,
         flops_g),
        ("frozen_tilt_energy", "twin", lambda: ft.reference_vertex(*base, grad=False), e_in,
         flops_e),
        ("frozen_tilt_energy_grad", "twin", lambda: ft.reference_vertex(*base, grad=True), e_in,
         flops_g),
        ("vertex_sum", "kernel", lambda: vs.launch(corner, csr), (corner, csr.offsets, csr.slots),
         corner.numel()),
        ("vertex_sum", "twin", lambda: vs.reference(corner, csr), (corner, csr.offsets, csr.slots),
         corner.numel()),
        ("vertex_sum", "library", lambda: out.index_add_(0, flat_rows, corner.reshape(-1, 3)),
         (corner, flat_rows), corner.numel()),
        ("frozen_tilt relax energy", "caller", relax_energy, e_in, flops_e),
        ("frozen_tilt eval_grads", "caller", eval_grads, e_in, flops_g),
    ]


def tri_rows_of(torch, tk, topo, positions, dtype) -> list:
    """(name, kind, fn, inputs, flops) for the per-triangle kernels, twins and callers."""
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.device import tilt_ops
    from membrane_solver_tpu_torch.energy import surface

    rng = np.random.default_rng(19)
    rows, v = topo.tri_rows, topo.tri_valid
    T, n = rows.shape[0], positions.shape[0]
    dev = rows.device
    p = positions.to(dtype).contiguous()
    tl = torch.as_tensor(0.3 * rng.standard_normal((n, 3)), dtype=dtype, device=dev)
    gamma = torch.where(v, 1.0, 0.0).to(dtype)
    cts = [torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)
           for s in ((T, 3), (T, 3, 3), (T, 3), (T,))]
    g_kvecs = torch.as_tensor(rng.standard_normal((n, 3)), dtype=dtype, device=dev)
    g_varea = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
    csr = topo.corner_csr()
    d_in = (p, rows, v)
    b_in = d_in + (g_kvecs, g_varea)
    F = FLOPS_PER_TRI

    def corners(x):
        return [x[rows[:, i]] for i in range(3)]

    def data_fwd():
        with torch.no_grad():
            return tk.curvature_data(p, rows, v, csr)

    def data_fwd_bwd():
        x = p.detach().requires_grad_(True)
        cd = tk.curvature_data(x, rows, v, csr)
        return torch.autograd.grad((cd.k_vecs, cd.vertex_areas), (x,), (g_kvecs, g_varea))

    tension = topo.tri_surface_tension.to(dtype)
    s_topo = dataclasses.replace(topo, tri_surface_tension=tension)
    s_in = (p, rows, v, tension)
    ws = tk.Workspace(T, dtype, dev)

    def surface_fwd_bwd():
        x = p.detach().requires_grad_(True)
        e = surface.energy(None, types.SimpleNamespace(positions=x), s_topo, {})
        return (e.detach(),) + torch.autograd.grad(e, (x,))

    ct_div = cts[3]
    div_in = (p, tl, rows, v)

    def div_fwd():
        with torch.no_grad():
            return tk.p1_triangle_divergence(p, tl, rows, v, csr)

    def div_fwd_bwd():
        t = tl.detach().requires_grad_(True)
        div, area, g = tk.p1_triangle_divergence(p, t, rows, v, csr)
        return (div.detach(), area, g) + torch.autograd.grad(div, (t,), (ct_div,))

    g_div = tilt_ops.p1_triangle_divergence(p, tl, rows, v)[2]
    bwd_in = (g_div, v, ct_div)
    e_flops, g_flops = F["surface_energy"] * T, (F["surface_energy"] + F["surface_grad"]) * T

    return [
        ("surface_energy", "kernel",
         lambda: tk.launch_surface_energy(p, rows, v, tension, csr, ws, grad=False), s_in,
         e_flops),
        ("surface_energy", "twin",
         lambda: tk.surface_energy_reference(p, rows, v, tension, csr, False), s_in, e_flops),
        ("surface_energy_grad", "kernel",
         lambda: tk.launch_surface_energy(p, rows, v, tension, csr, ws, grad=True), s_in,
         g_flops),
        ("surface_energy_grad", "twin",
         lambda: tk.surface_energy_reference(p, rows, v, tension, csr, True), s_in, g_flops),
        ("p1_div", "kernel", lambda: tk.launch_p1_divergence(p, tl, rows, v), div_in,
         F["p1_div"] * T),
        ("p1_div", "twin", lambda: tilt_ops.p1_triangle_divergence(p, tl, rows, v), div_in,
         F["p1_div"] * T),
        ("p1_div_bwd", "kernel", lambda: tk.launch_p1_div_bwd(g_div, v, ct_div, csr), bwd_in,
         F["p1_div_bwd"] * T),
        ("p1_div_bwd", "twin", lambda: tk.p1_div_vjp_reference(g_div, v, ct_div, csr), bwd_in,
         F["p1_div_bwd"] * T),
        ("surface_fwd", "kernel", lambda: tk.launch_surface(p, rows, gamma), (p, rows, gamma),
         g_flops),
        ("surface_fwd", "twin", lambda: dgeo.surface_corner_terms(*corners(p), gamma),
         (p, rows, gamma), g_flops),
        ("curvature_fwd", "kernel", lambda: tk.launch_curvature(p, rows, v), d_in,
         F["curvature_fwd"] * T),
        ("curvature_fwd", "twin", lambda: dgeo.curvature_corners(*corners(p), v), d_in,
         F["curvature_fwd"] * T),
        ("curvature_bwd", "kernel", lambda: tk.launch_curvature_bwd(p, rows, v, *cts),
         (p, rows, v, *cts), F["curvature_bwd"] * T),
        ("curvature_bwd", "twin", lambda: tk.curvature_corners_vjp(p, rows, v, *cts),
         (p, rows, v, *cts), F["curvature_bwd"] * T),
        ("curvature_data", "kernel", lambda: tk.launch_curvature_data(p, rows, v, csr), d_in,
         F["curvature_fwd"] * T),
        ("curvature_data", "twin", lambda: tk.curvature_data_reference(p, rows, v, csr), d_in,
         F["curvature_fwd"] * T),
        ("curvature_data_bwd", "kernel",
         lambda: tk.launch_curvature_data_bwd(p, rows, v, csr, g_kvecs, g_varea, None, None),
         b_in, F["curvature_bwd"] * T),
        ("curvature_data_bwd", "twin",
         lambda: tk.curvature_data_vjp_reference(p, rows, v, csr, g_kvecs, g_varea, None, None),
         b_in, F["curvature_bwd"] * T),
        ("curvature_data", "caller", data_fwd, d_in, F["curvature_fwd"] * T),
        ("curvature_data fwd+bwd", "caller", data_fwd_bwd, b_in,
         (F["curvature_fwd"] + F["curvature_bwd"]) * T),
        ("surface energy fwd+bwd", "caller", surface_fwd_bwd, s_in, g_flops),
        ("bending-tilt divergence", "caller", div_fwd, div_in, F["p1_div"] * T),
        ("divergence fwd+tilt bwd", "caller", div_fwd_bwd, div_in + (ct_div,),
         (F["p1_div"] + F["p1_div_bwd"]) * T),
    ]


def measure(torch, rows: list, lane: str, dtype_name: str) -> list:
    """Times each row (``time_call``; callers also ``synced_us``) and computes its bound."""
    recs = []
    for name, kind, fn, inputs, flops in rows:
        outputs = _flat(fn())
        torch.cuda.synchronize()
        calls = CALLER_CALLS if kind == "caller" else LOOP
        timing = time_call(torch, fn, calls=calls)
        moved = _nbytes(inputs) + _nbytes(outputs)
        bound, bound_by = bound_ms(moved, flops, dtype_name)
        rec = {"name": name, "kind": kind, "lane": lane, "dtype": dtype_name, "calls": calls,
               **{k: v for k, v in timing.items() if k != "ops"},
               "bytes": moved, "bound_ms": bound, "bound_by": bound_by,
               "ops": {k[:80]: c for k, c in timing["ops"].items()}}
        if kind == "caller":
            rec["synced_us"] = synced_us(torch, fn)
        recs.append(rec)
    return recs


# ----------------------------------------------------------------------
# phase 3: every kernel against its twin
# ----------------------------------------------------------------------
def _ft_inputs(torch, rows, nv: int, seed: int):
    """Seeded (t_in, t_out, g, payload, k_vec) float32 on the card for ``rows``' triangles."""
    rng = np.random.default_rng(seed)
    T = rows.shape[0]
    f32 = np.float32
    arrays = (
        rng.standard_normal((nv, 3)).astype(f32),
        rng.standard_normal((nv, 3)).astype(f32),
        rng.standard_normal((T, 3, 3)).astype(f32),
        np.abs(rng.standard_normal((T, 20))).astype(f32),
        rng.uniform(0.5, 2.0, 6).astype(f32),
    )
    return [torch.from_numpy(a).to(DEVICE) for a in arrays]


def check_frozen_tilt(torch, ft, rows, nv: int, seed: int) -> dict:
    """The entry point (energy alone, energy and gradients) vs its twin; max abs errors."""
    from membrane_solver_tpu_torch.device.state import corner_csr

    t_in, t_out, g, pay, k = _ft_inputs(torch, rows, nv, seed)
    csr = corner_csr(rows, nv)
    ws = ft.Workspace(rows.shape[0], rows.device)
    want_e, want_in, want_out = ft.reference_vertex(t_in, t_out, rows, csr, g, pay, k, grad=True)
    e_only, _, _ = ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=False)
    e, gin, gout = ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=True)
    e_err = max(abs(float(x) - float(want_e)) for x in (e_only, e))
    if not (math.isfinite(e_err) and e_err <= ENERGY_RTOL * abs(float(want_e))):
        raise AssertionError(f"T={rows.shape[0]}: kernel energy {float(e)!r} vs twin {float(want_e)!r}")
    g_err, g_rel = 0.0, 0.0
    for got, want in ((gin, want_in), (gout, want_out)):
        err = float(torch.max(torch.abs(got - want)))
        scale = float(torch.max(torch.abs(want)))
        if not err <= GRAD_RTOL * scale:
            raise AssertionError(f"T={rows.shape[0]}: vertex gradient error {err!r} > "
                                 f"{GRAD_RTOL} * {scale!r}")
        g_err, g_rel = max(g_err, err), max(g_rel, err / scale)
    return {"ft_energy": e_err, "ft_grad": g_err, "energy_rel_err": e_err / abs(float(want_e)),
            "grad_rel_err": g_rel}


def check_vertex_sum(torch, vs, rows, nv: int) -> float:
    """The vertex-sum kernel against its twin: equal bits, float32 and float64, widths 1 and 3."""
    from membrane_solver_tpu_torch.device.state import corner_csr

    csr = corner_csr(rows, nv)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for dtype in (torch.float32, torch.float64):
        for shape in ((rows.shape[0], 3), (rows.shape[0], 3, 3)):
            vals = torch.randn(shape, dtype=dtype, device=DEVICE, generator=gen)
            got, want = vs.launch(vals, csr), vs.reference(vals, csr)
            if not torch.equal(got, want):
                err = float(torch.max(torch.abs(got - want)))
                raise AssertionError(f"vertex_sum {dtype} {shape}: differs from its twin by {err!r}")
    return 0.0


def _seeded_triangles(T: int, seed: int):
    """(positions, tri_rows, valid, tilts) as float64 numpy: random distinct-corner triangles."""
    rng = np.random.default_rng(seed)
    nv = T // 2 + 3
    rows = rng.integers(0, nv, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (nv - 2)) % nv
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (nv - 2)) % nv
    valid = np.ones(T, dtype=bool)
    valid[-7:] = False
    return rng.standard_normal((nv, 3)), rows, valid, 0.3 * rng.standard_normal((nv, 3))


def _lane_triangles(prob, seed: int, unit_edges: bool = False):
    """A lane's own triangles: its positions, perturbed by 1e-3, as numpy.

    With ``unit_edges``, the positions are first scaled to a mean edge
    length of 1: the float32 bounds are absolute at that scale, and every
    kernel here is scale-covariant.
    """
    rng = np.random.default_rng(seed)
    pos = prob.state.positions.detach().cpu().numpy()
    rows = prob.topo.tri_rows.cpu().numpy()
    if unit_edges:
        pos = pos / np.mean(np.linalg.norm(pos[rows] - pos[np.roll(rows, 1, axis=1)], axis=2))
    pos = pos + 1e-3 * rng.standard_normal(pos.shape)
    return pos, rows, prob.topo.tri_valid.cpu().numpy(), 0.3 * rng.standard_normal(pos.shape)


def _tk_check(torch, name, got, want, dtype, kind, rows=None) -> float:
    """Max abs error of kernel vs twin; raises beyond the stated tolerance."""
    if rows is not None:
        got, want = got[rows], want[rows]
    err = torch.abs(got - want)
    max_err = float(torch.max(err)) if err.numel() else 0.0
    if dtype == torch.float64:
        scale = max(float(torch.max(torch.abs(want))), 1.0)
        ok = max_err <= TK_F64 * scale
        bound = f"{TK_F64} * {scale!r}"
    else:
        rtol, atol = TK_F32[kind]
        ok = bool(torch.all(err <= atol + rtol * torch.abs(want)))
        bound = f"{atol} + {rtol} * |want|"
    if not (ok and math.isfinite(max_err)):
        raise AssertionError(f"{name} ({dtype}): max abs err {max_err!r} beyond {bound}")
    return max_err


def _bwd_check(torch, name, got, want, dtype, rows) -> float:
    if not bool(torch.any(rows)):
        return 0.0  # every row at a tie
    err = float(torch.max(torch.abs(got[rows] - want[rows])))
    scale = float(torch.max(torch.abs(want[rows])))
    if not err <= TK_BWD[str(dtype).removeprefix("torch.")] * scale:
        raise AssertionError(f"{name} ({dtype}): max abs err {err!r}, max|g| {scale!r}")
    return err


def _sum_check(torch, name, got, want, rtol: float) -> float:
    """Max abs error of a vertex sum (or a scalar) against its twin, within rtol of max|want|."""
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    if not err <= rtol * scale:
        raise AssertionError(f"{name}: max abs err {err!r} beyond {rtol} * {scale!r}")
    return err


def check_whole_calls(torch, tk, p, t_rows, v, tl, csr, seed: int) -> dict:
    """The surface and divergence whole calls vs their twins: max abs errors.

    The surface energy alone and with its vertex gradient (a seeded tension
    on every triangle, masked by ``v`` in the kernel), the masked divergence
    and its tilt backward (on the twin's shape gradients and a seeded
    upstream).
    """
    from membrane_solver_tpu_torch.device import tilt_ops

    dtype, T = p.dtype, t_rows.shape[0]
    name = str(dtype).removeprefix("torch.")
    rng = np.random.default_rng(seed + 1)
    tension = torch.as_tensor(rng.uniform(0.5, 2.0, T), dtype=dtype, device=DEVICE)
    ws = tk.Workspace(T, dtype, DEVICE)
    e_only, _ = tk.launch_surface_energy(p, t_rows, v, tension, csr, ws, grad=False)
    e, dpos = tk.launch_surface_energy(p, t_rows, v, tension, csr, ws, grad=True)
    want_e, want_g = tk.surface_energy_reference(p, t_rows, v, tension, csr, True)
    errs = {
        "surface_energy": max(_sum_check(torch, f"surface energy ({name})", x[0], want_e,
                                         WC_ENERGY[name]) for x in (e_only, e)),
        "surface_grad": _sum_check(torch, f"surface vertex gradient ({name})", dpos, want_g,
                                   WC_SURFACE_GRAD[name]),
    }
    div, area, g = tk.launch_p1_divergence(p, tl, t_rows, v)
    want = tilt_ops.p1_triangle_divergence(p, tl, t_rows, v)
    errs["p1_div"] = max(
        _tk_check(torch, "masked p1 div", div, want[0], dtype, "curv"),
        _tk_check(torch, "masked p1 area", area, want[1], dtype, "curv"),
        _tk_check(torch, "masked p1 g", g, want[2], dtype, "curv"),
    )
    ct = torch.as_tensor(rng.standard_normal(T), dtype=dtype, device=DEVICE)
    errs["p1_div_bwd"] = _sum_check(torch, f"p1 div tilt backward ({name})",
                                    tk.launch_p1_div_bwd(want[2], v, ct, csr),
                                    tk.p1_div_vjp_reference(want[2], v, ct, csr), WC_DIV_BWD[name])
    return errs


def check_tri_kernels(torch, tk, arrays, dtype, seed: int, data: bool) -> tuple[dict, int]:
    """The per-triangle kernels, the surface and divergence whole calls (and, with
    ``data``, the curvature data) vs their twins.

    Returns the max abs errors and the number of rows left out at a tie.
    """
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.device.state import corner_csr

    pos, rows, valid, tilts = arrays
    dev = DEVICE
    p = torch.as_tensor(pos, dtype=dtype, device=dev)
    t_rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    v = torch.as_tensor(valid, device=dev)
    tl = torch.as_tensor(tilts, dtype=dtype, device=dev)
    T = t_rows.shape[0]
    corners = [p[t_rows[:, i]] for i in range(3)]
    csr = corner_csr(t_rows, p.shape[0])
    errs = check_whole_calls(torch, tk, p, t_rows, v, tl, csr, seed)

    gamma = torch.where(v, 1.7, 0.0).to(dtype)
    e, g = tk.launch_surface(p, t_rows, gamma)
    want = dgeo.surface_corner_terms(*corners, gamma)
    errs["surface_fwd"] = max(_tk_check(torch, "surface e", e, want[0], dtype, "e"),
                              _tk_check(torch, "surface g", g, torch.stack(want[1:], 1), dtype, "g"))

    cot, k, va, area = tk.launch_curvature(p, t_rows, v)
    want = dgeo.curvature_corners(*corners, v)
    clear = ~(v & torch.any(torch.abs(want[0]) < TIE, dim=1))
    errs["curvature_fwd"] = max(
        _tk_check(torch, "curvature cot", cot, want[0], dtype, "curv", clear),
        _tk_check(torch, "curvature k", k, torch.stack(want[1:4], 1), dtype, "curv", clear),
        _tk_check(torch, "curvature va", va, want[4], dtype, "curv", clear),
        _tk_check(torch, "curvature area", area, want[5], dtype, "curv"),
    )

    rng = np.random.default_rng(seed)
    cts = [torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)
           for s in ((T, 3), (T, 3, 3), (T, 3), (T,))]
    dp = tk.launch_curvature_bwd(p, t_rows, v, *cts)
    want = tk.curvature_corners_vjp(p, t_rows, v, *cts)
    errs["curvature_bwd"] = _bwd_check(torch, "curvature bwd", dp, want, dtype, clear)

    if data:
        vclear = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
        vclear[t_rows[~clear].reshape(-1)] = False  # vertex sums free of tie rows
        got = tk.launch_curvature_data(p, t_rows, v, csr)
        want = tk.curvature_data_reference(p, t_rows, v, csr)
        errs["curvature_data"] = max(
            _tk_check(torch, "curvature data " + name, a, b, dtype, "curv", rows_ok)
            for a, b, name, rows_ok in zip(got, want, ("cot", "va", "k_vecs", "vertex_areas"),
                                           (clear, clear, vclear, vclear)))
        ups = (torch.as_tensor(rng.standard_normal((p.shape[0], 3)), dtype=dtype, device=dev),
               torch.as_tensor(rng.standard_normal(p.shape[0]), dtype=dtype, device=dev),
               cts[0], cts[2])
        dpos = tk.launch_curvature_data_bwd(p, t_rows, v, csr, *ups)
        want = tk.curvature_data_vjp_reference(p, t_rows, v, csr, *ups)
        errs["curvature_data_bwd"] = _bwd_check(torch, "curvature data bwd", dpos, want, dtype,
                                                vclear)

    torch.cuda.synchronize()
    return errs, int(T - int(torch.sum(clear)))


def check_tri_sets(torch, tk, phase: str, sets, errs_out: dict) -> None:
    """check_tri_kernels at float32 and float64 on each (label, arrays, seed, data); folds max errors."""
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        for label, arrays, seed, data in sets:
            errs, ties = check_tri_kernels(torch, tk, arrays, dtype, seed, data)
            say(phase, dtype=name, inputs=repr(label), live_rows=int(np.sum(arrays[2])),
                tie_rows_left_out=ties, **{k: repr(v) for k, v in errs.items()})
            for k, v in errs.items():
                errs_out[k] = max(errs_out.get(k, 0.0), v)


def kozlov_triangles(torch, mn) -> list:
    """The kozlov lane's own kernel inputs after its run, one set per leaflet.

    Positions and that leaflet's tilts as the run left them, and the mask
    its bending-tilt curvature call takes (``tri_valid & tri_present``).
    """
    from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles

    p = mn.problem()
    pos = p.state.positions.detach().cpu().numpy()
    rows = p.topo.tri_rows.cpu().numpy()
    sets = []
    for leaflet, tilts in (("in", p.state.tilts_in), ("out", p.state.tilts_out)):
        present = present_triangles(p.topo, leaflet)
        keep = p.topo.tri_valid if present is None else p.topo.tri_valid & present
        sets.append((f"kozlov leaflet {leaflet} T={rows.shape[0]}",
                     (pos, rows, keep.cpu().numpy(), tilts.detach().cpu().numpy()), 19, True))
    return sets


def sheet_triangles(prob) -> list:
    """The rect sheet's triangles as a run left them, and the same perturbed by 1e-3."""
    pos = prob.state.positions.detach().cpu().numpy()
    rows = prob.topo.tri_rows.cpu().numpy()
    tilts = 0.3 * np.random.default_rng(37).standard_normal(pos.shape)
    valid = prob.topo.tri_valid.cpu().numpy()
    return [(f"rect sheet T={rows.shape[0]}", (pos, rows, valid, tilts), 37, True),
            (f"rect sheet T={rows.shape[0]} +1e-3", _lane_triangles(prob, 37), 37, True)]


def check_area_calls(torch, tk, phase: str, prob, errs_out: dict) -> None:
    """The surface whole call as the square_to_circle path calls it, on that lane's last triangles.

    ``surface_energy_and_gradient`` against ``surface_energy_reference(...,
    True)`` at the topology's own tension (``surface``, zero on this lane)
    and at unit tension (``global_area``), both masked by ``tri_valid``, at
    float32 and float64 with phase 3's whole-call bounds; then phase 3's
    tri-kernel checks on the same triangles, scaled to unit mean edge
    length (the lane's edges are ~0.009 long, and a 1e-3 perturbation there
    makes slivers whose float32 divergence exceeds the unit-scale bounds by
    round-off alone).
    """
    topo = prob.topo
    rows, valid, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        pos = prob.state.positions.detach().to(dtype)
        ws = tk.workspace(topo, pos)
        tension = topo.tri_surface_tension.to(dtype)
        for module, t in (("surface", tension), ("global_area", torch.ones_like(tension))):
            e, g = tk.surface_energy_and_gradient(pos, rows, valid, t, csr, ws)
            want_e, want_g = tk.surface_energy_reference(pos, rows, valid, t, csr, True)
            errs = {
                "surface_energy": _sum_check(torch, f"{module} area call energy ({name})", e,
                                             want_e, WC_ENERGY[name]),
                "surface_grad": _sum_check(torch, f"{module} area call gradient ({name})", g,
                                           want_g, WC_SURFACE_GRAD[name]),
            }
            say(phase, dtype=name, module=module, T=rows.shape[0], max_tension=repr(float(t.max())),
                energy=repr(float(e)), **{k: repr(v) for k, v in errs.items()})
            for k, v in errs.items():
                errs_out[k] = max(errs_out.get(k, 0.0), v)
    check_tri_sets(torch, tk, phase + " tri kernels",
                   ((f"square_to_circle T={rows.shape[0]}, unit edges",
                     _lane_triangles(prob, 17, unit_edges=True), 17, True),),
                   errs_out)


def check_determinism(torch, ft, tk, kozlov) -> dict:
    """Two energy-plus-gradient calls of each redesigned entry point give the same bits.

    The frozen-tilt energy and the surface energy with their gradients, the
    curvature data and the divergence forward with their backwards.
    Also runs one such call of each under torch.profiler and fails on a
    PyTorch index, scatter, gather, sort or reduction kernel among its
    device operations.  Returns the device operations by entry point.
    """
    topo, nv = kozlov.topo, kozlov.n_vertices
    rows, csr = topo.tri_rows, topo.corner_csr()
    t_in, t_out, g, pay, k = _ft_inputs(torch, rows, nv, 23)
    ws = ft.Workspace(rows.shape[0], rows.device)
    pos = kozlov.state.positions.detach().to(torch.float32)
    rng = np.random.default_rng(29)
    ups = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device=DEVICE)
           for s in ((nv, 3), (nv,), (rows.shape[0], 3))]

    def frozen_tilt():
        a, b = t_in.detach().requires_grad_(True), t_out.detach().requires_grad_(True)
        e = ft.frozen_tilt_energy(a, b, rows, csr, g, pay, k, ws)
        return (e.detach(),) + torch.autograd.grad(e, (a, b))

    def curvature():
        x = pos.detach().requires_grad_(True)
        cd = tk.curvature_data(x, rows, topo.tri_valid, csr)
        outs = (cd.k_vecs, cd.vertex_areas, cd.corner_areas)
        return tuple(o.detach() for o in outs) + torch.autograd.grad(outs, (x,), tuple(ups))

    tension = topo.tri_surface_tension.to(torch.float32)
    s_ws = tk.Workspace(rows.shape[0], torch.float32, DEVICE)
    tilts = torch.as_tensor(0.3 * rng.standard_normal((nv, 3)), dtype=torch.float32, device=DEVICE)
    ct = torch.as_tensor(rng.standard_normal(rows.shape[0]), dtype=torch.float32, device=DEVICE)

    def surface():
        x = pos.detach().requires_grad_(True)
        e = tk.surface_energy(x, rows, topo.tri_valid, tension, csr, s_ws)
        return (e.detach(),) + torch.autograd.grad(e, (x,))

    def divergence():
        t = tilts.detach().requires_grad_(True)
        div, area, grads = tk.p1_triangle_divergence(pos, t, rows, topo.tri_valid, csr)
        return (div.detach(), area, grads) + torch.autograd.grad(div, (t,), (ct,))

    ops = {}
    for name, fn in (("frozen_tilt_energy", frozen_tilt), ("curvature_data", curvature),
                     ("surface_energy", surface), ("p1_triangle_divergence", divergence)):
        first, second = fn(), fn()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{name}: two energy-plus-gradient calls differ")
        ops[name] = device_ops(torch, fn)
        bad = [n for n in ops[name]
               if LIBRARY_KERNEL.search(n) and not any(o in n for o in OWN_KERNELS)]
        if bad:
            raise AssertionError(f"{name}: PyTorch's own index/scatter/reduction kernels ran: {bad}")
        say("3 determinism", entry=name, repeat_equal=True,
            device_ops=json.dumps([n[:60] for n in ops[name]]))
    return ops


def time_kernels(torch, ft, tk, kozlov) -> dict:
    """Every timing row at the kozlov L3 lane's shapes, float32, keyed by (name, kind)."""
    rows = frozen_tilt_rows(torch, ft, kozlov.topo, kozlov.n_vertices)
    rows += tri_rows_of(torch, tk, kozlov.topo, kozlov.state.positions.detach(), torch.float32)
    recs = measure(torch, rows, "kozlov_L3", "float32")
    for r in recs:
        say("3 timing", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                           for k, v in r.items() if k != "ops"})
    return {(r["name"], r["kind"]): r for r in recs}


def phase_kernels(torch, mods, kozlov, vesicle) -> dict:
    """Phase 3 on the two lanes' topologies: checks, determinism, profile check, timing."""
    ft, tk, vs = mods
    errs = {}
    for label, rows, nv, seed in (
            ("T=301", *_seeded_ft_rows(torch, 301, 7), 7),
            (f"kozlov T={kozlov.n_tris}", kozlov.topo.tri_rows, kozlov.n_vertices, 13)):
        e = check_frozen_tilt(torch, ft, rows, nv, seed)
        say("3 frozen tilt", inputs=repr(label), energy_abs_err=repr(e["ft_energy"]),
            energy_rel_err=repr(e["energy_rel_err"]), grad_max_abs_err=repr(e["ft_grad"]),
            grad_err_of_max_g=repr(e["grad_rel_err"]))
        for key in ("ft_energy", "ft_grad"):
            errs[key] = max(errs.get(key, 0.0), e[key])
    errs["vertex_sum"] = check_vertex_sum(torch, vs, kozlov.topo.tri_rows, kozlov.n_vertices)
    say("3 vertex sum", T=kozlov.n_tris, equal_to_twin=True)
    check_tri_sets(torch, tk, "3 tri kernels", (
        ("T=301", _seeded_triangles(301, 7), 7, False),
        (f"vesicle T={vesicle.n_tris}", _lane_triangles(vesicle, 17), 17, True),
        (f"kozlov T={kozlov.n_tris}", _lane_triangles(kozlov, 17), 17, True),
    ), errs)
    check_determinism(torch, ft, tk, kozlov)
    return {"errs": errs, "timing": time_kernels(torch, ft, tk, kozlov)}


def _seeded_ft_rows(torch, T: int, seed: int):
    """(tri_rows on the card, vertex count) of seeded distinct-corner triangles."""
    _pos, rows, _valid, _tilts = _seeded_triangles(T, seed)
    return torch.as_tensor(rows, device=DEVICE), T // 2 + 3


# ----------------------------------------------------------------------
# the main paths
# ----------------------------------------------------------------------
def load_fixture(path: Path = KOZLOV_FIXTURE) -> dict:
    """A JAX trajectory and the protocol it was recorded with.

    The fixture's ``protocol`` block (mesh, modules, global parameters, step
    size, refinement rounds, steps) is what ``run_protocol`` runs, so the
    two cannot drift.
    """
    fixture = json.loads(path.read_text())
    proto = fixture["protocol"]
    if proto["mesh"] not in ("meshgen kozlov_1disk", "meshgen cube") or proto["dtype"] != "float64":
        raise AssertionError(f"unexpected fixture protocol: {proto}")
    if len(fixture["energies"]) != proto["steps"] or proto["steps"] < 2:
        raise AssertionError(f"fixture holds {len(fixture['energies'])} energies for {proto['steps']} steps")
    return fixture


def build_lane(torch, protocol: dict, dtype):
    """A fixture protocol's lane on the card up to its first step: build, parse, refine."""
    from membrane_solver_tpu_torch import Minimizer, parse_geometry
    from membrane_solver_tpu_torch.meshgen import build
    from membrane_solver_tpu_torch.runtime.refinement import (
        refine_polygonal_facets,
        refine_triangle_mesh,
    )

    if protocol["mesh"] == "meshgen kozlov_1disk":
        mesh = parse_geometry(build("kozlov_1disk"))
        mesh.global_parameters.update(protocol["global_parameters"])
        mn = Minimizer(mesh, device=DEVICE, dtype=dtype, quiet=True)
        mn.step_size = protocol["step_size"]
        for _ in range(protocol["refines"]):
            m = refine_polygonal_facets(mn.mesh)
            m = refine_triangle_mesh(m)
            mn.mesh = m
            mn.invalidate()
            mn.enforce_constraints_after_mesh_ops()
        return mn
    data = build("cube")
    if protocol["drop_instructions"]:
        data.pop("instructions", None)
    data["energy_modules"] = list(protocol["energy_modules"])
    data["constraint_modules"] = list(protocol["constraint_modules"])
    data["global_parameters"].update(protocol["global_parameters"])
    mn = Minimizer(parse_geometry(data), device=DEVICE, dtype=dtype, quiet=True)
    mn.step_size = protocol["step_size"]
    for _ in range(protocol["polygonal_refines"]):
        mn.mesh = refine_polygonal_facets(mn.mesh)
    for _ in range(protocol["refines"]):
        mn.mesh = refine_triangle_mesh(mn.mesh)
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    return mn


def run_protocol(torch, dtype, protocol: dict):
    """A fixture's protocol on the card.

    Returns (minimizer, per-step energies, per-step (accepted, next step
    size), set-up seconds).
    """
    t0 = time.perf_counter()
    mn = build_lane(torch, protocol, dtype)
    setup_s = time.perf_counter() - t0
    energies, steps = [], []
    for _ in range(protocol["steps"]):
        res = mn.minimize(1)
        energies.append(float(res["energy"]))
        steps.append((bool(res["step_success"]), float(mn.step_size)))
    return mn, energies, steps, setup_s


def timed_steps(torch, mn) -> float:
    mn.minimize(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mn.minimize(TIMED_STEPS)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / max(int(res["iterations"]), 1)


def count_syncs(torch, step) -> tuple[int, list]:
    """Synchronizing CUDA operations in one call of ``step()``: (count, [(n, "file:line")], most first)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{Path(w.filename).relative_to(REPO) if Path(w.filename).is_relative_to(REPO) else w.filename}"
        f":{w.lineno}" for w in caught if "synchronizing" in str(w.message))
    return sum(sites.values()), [(n, site) for site, n in sites.most_common()]


def reset_counts(counters) -> None:
    for launches in counters.values():
        for key in launches:
            launches[key] = 0


def read_counts(counters) -> dict:
    return {f"{mod}.{key}": n for mod, launches in counters.items() for key, n in launches.items()}


STATE_FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")


def snapshot(mn) -> dict:
    """What a run from the minimizer's current state starts from: host mesh, step, stepper, theta_B."""
    mn.problem()
    mn._sync_host()
    verts = {vid: tuple(getattr(v, f).copy() for f in ("position", "tilt", "tilt_in", "tilt_out"))
             for vid, v in mn.mesh.vertices.items()}
    return {"verts": verts, "step_size": mn.step_size, "stepper": mn._stepper_state,
            "thetaB": mn.global_params.get("tilt_thetaB_value")}


def restore(mn, snap: dict) -> None:
    """Back to ``snap``: the host mesh written back, the problem compiled anew from it."""
    for vid, arrays in snap["verts"].items():
        v = mn.mesh.vertices[vid]
        for f, a in zip(("position", "tilt", "tilt_in", "tilt_out"), arrays):
            getattr(v, f)[:] = a
    if snap["thetaB"] is not None:  # the theta_B scan writes it
        mn.global_params.set("tilt_thetaB_value", snap["thetaB"])
    mn.invalidate()
    mn.problem()
    mn._stepper_state = snap["stepper"]
    mn.step_size = snap["step_size"]


def state_digest(torch, mn, energies) -> str:
    """sha256 of the device positions and tilts and of the energies, as bytes."""
    state = mn.problem().state
    h = hashlib.sha256()
    for f in STATE_FIELDS:
        h.update(getattr(state, f).detach().cpu().numpy().tobytes())
    h.update(np.asarray(energies, dtype=np.float64).tobytes())
    return h.hexdigest()


def check_repeat(torch, label: str, mn, run) -> dict:
    """Run ``run()`` twice from one saved state; unequal digests fail.

    ``run`` makes two steps and returns the energies it reports; the phase
    goes on from the second run's state.  Returns the saved state.
    """
    snap = snapshot(mn)
    digests = []
    for _ in range(2):
        restore(mn, snap)
        energies = run()
        torch.cuda.synchronize()
        digests.append(state_digest(torch, mn, energies))
    say(label + " determinism", steps=2, first=digests[0], second=digests[1],
        equal=digests[0] == digests[1])
    if digests[0] != digests[1]:
        raise AssertionError(f"{label}: two runs from one state differ: {digests}")
    return snap


def phase_path(torch, counters, label: str, fixture: dict, dtype, expect: tuple,
               f32_energies=None) -> dict:
    """Drive one lane at one dtype with the launch counts reset just before and read just after."""
    reset_counts(counters)
    mn, energies, steps, setup_s = run_protocol(torch, dtype, fixture["protocol"])
    snap = check_repeat(torch, label, mn, lambda: [float(mn.minimize(2)["energy"])])
    ms = timed_steps(torch, mn)
    launches = read_counts(counters)
    p = mn.problem()
    if (p.n_vertices, p.n_tris) != (fixture["n_vertices"], fixture["n_triangles"]):
        raise AssertionError(f"{label}: mesh size {(p.n_vertices, p.n_tris)} differs from the fixture")
    if not all(math.isfinite(e) for e in energies) or not energies[-1] < energies[0]:
        raise AssertionError(f"{label}: energies not finite and descending: {energies}")
    fields = {"vertices": p.n_vertices, "triangles": p.n_tris, "setup_s": f"{setup_s:.3f}",
              "energies": json.dumps(energies), "steps": json.dumps(steps),
              "ms_per_step": f"{ms:.3f}", "launches": json.dumps(launches)}
    out = {"energies": energies, "ms": ms, "launches": launches, "mn": mn, "snap": snap}
    if dtype == torch.float64:
        ref = fixture["energies"]
        out["dev_jax"] = max(abs(a - b) / abs(b) for a, b in zip(energies, ref, strict=True))
        fields["max_rel_dev_vs_jax"] = repr(out["dev_jax"])
        fields["jax_step_sizes"] = json.dumps(fixture["step_sizes"])
    if f32_energies is not None:
        devs = [abs(a - b) / abs(b) for a, b in zip(f32_energies, energies, strict=True)]
        out["dev_f32"] = max(devs)
        fields["rel_dev_f32_vs_f64_per_step"] = json.dumps(devs)
        fields["max_rel_dev_f32_vs_f64"] = repr(out["dev_f32"])
    fields["syncs_per_step"], sites = count_syncs(torch, lambda: mn.minimize(1))
    say(label, **fields)
    say(label + " sync sites", sites=json.dumps(sites))
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if "dev_jax" in out and not out["dev_jax"] <= F64_RTOL:
        raise AssertionError(f"{label}: f64 trajectory deviates from the JAX fixture by {out['dev_jax']!r}")
    if "dev_f32" in out and not out["dev_f32"] <= F32_RTOL:
        raise AssertionError(f"{label}: f32 trajectory deviates from f64 by {out['dev_f32']!r}")
    return out


def connectivity_digest(mesh) -> str:
    """sha256 of the facets' signed edge lists and the edges' endpoints, by id."""
    text = json.dumps([sorted((int(f), [int(e) for e in mesh.facets[f].edge_indices])
                              for f in mesh.facets),
                       sorted((int(e), int(mesh.edges[e].tail_index), int(mesh.edges[e].head_index))
                              for e in mesh.edges)])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def cli_context(torch, protocol: dict, dtype):
    """The command context ``cli.main`` builds for the protocol's command line, on the card.

    A meshgen protocol's lane is first written to a JSON file, as
    ``python -m membrane_solver_tpu_torch.meshgen NAME --set k=v -o FILE``
    writes it, and the CLI loads that file.
    """
    import tempfile

    from membrane_solver_tpu_torch import cli
    from membrane_solver_tpu_torch.meshgen import build

    with tempfile.TemporaryDirectory() as tmp:
        mesh_path = REPO / protocol["mesh"]
        if "meshgen" in protocol:
            spec = protocol["meshgen"]
            mesh_path = Path(tmp) / protocol["mesh"]
            mesh_path.write_text(json.dumps(build(spec["name"], **spec["args"])))
        argv = [str(mesh_path) if a == protocol["mesh"] else a for a in protocol["cli_args"]]
        args = cli.build_parser().parse_args(argv + (["--f32"] if dtype == torch.float32 else []))
        return cli.make_context(args, cli.load_mesh_interactive(args.input, interactive=False))


def g1_split(torch, ctx) -> dict:
    """Host seconds, synced, of one ``g1`` command, one ``minimize(1)`` and the ``g`` command's collision scan."""
    from membrane_solver_tpu_torch.commands import execute_command_line
    from membrane_solver_tpu_torch.runtime.topology_guards import detect_vertex_edge_collisions

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return {"g1_s": timed(lambda: execute_command_line(ctx, "g1")),
            "minimize_1_s": timed(lambda: ctx.minimizer.minimize(1)),
            "collision_scan_s": timed(lambda: detect_vertex_edge_collisions(ctx.mesh))}


def phase_cli(torch, counters, label: str, fixture: dict, dtype, expect: tuple, f32=None,
              split: bool = False) -> dict:
    """The fixture's command list through the command layer, counts reset just before and read after.

    With ``split``, a ``g1`` split (:func:`g1_split`) follows the counted run.
    """
    from membrane_solver_tpu_torch.commands import execute_command_line

    proto, trace = fixture["protocol"], fixture["trace"]
    jax_f32 = fixture["float32_reference"]
    reset_counts(counters)
    ctx = cli_context(torch, proto, dtype)
    rows, digests = [], []
    for cmd in proto["commands"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        execute_command_line(ctx, cmd)
        ctx.sync_mesh()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        mn = ctx.minimizer
        row = {"cmd": cmd, "energy": float(mn.compute_energy()),
               "n_vertices": len(ctx.mesh.vertices), "n_facets": len(ctx.mesh.facets),
               "host_s": seconds}
        name = cmd.split()[0]
        if name[0] == "g" and name[1:].isdigit():
            row["ms_per_step"] = seconds * 1e3 / int(name[1:])
        if cmd == "u":
            digests.append(connectivity_digest(ctx.mesh))
            row["connectivity"] = digests[-1]
            if dtype == torch.float32:
                # the JAX package's own float32 run after the same command
                i = len(rows)
                row["jax_f32_counts"] = jax_f32["counts"][i]
                row["jax_f32_connectivity"] = jax_f32["connectivity"][i]
                row["jax_f32_connectivity_equal"] = jax_f32["connectivity"][i] == digests[-1]
        rows.append(row)
        say(label + " command", **{k: (f"{v:.6f}" if k in ("host_s", "ms_per_step") else repr(v))
                                   for k, v in row.items()})

    def g2():
        execute_command_line(ctx, "g2")
        ctx.sync_mesh()
        return [float(ctx.minimizer.compute_energy())]

    check_repeat(torch, label, ctx.minimizer, g2)
    syncs, sites = count_syncs(torch, lambda: execute_command_line(ctx, "g1"))
    launches = read_counts(counters)
    energies = [r["energy"] for r in rows]
    out = {"energies": energies, "rows": rows, "digests": digests, "launches": launches,
           "mn": ctx.minimizer}
    fields = {"vertices": rows[-1]["n_vertices"], "facets": rows[-1]["n_facets"],
              "launches": json.dumps(launches), "g1_host_syncs": syncs}
    if dtype == torch.float32:
        fields["jax_f32_connectivity_after_u_equal"] = json.dumps(
            [r["jax_f32_connectivity_equal"] for r in rows if r["cmd"] == "u"])
    if not all(math.isfinite(e) for e in energies):
        raise AssertionError(f"{label}: non-finite energies: {energies}")
    if dtype == torch.float64:
        if len(rows) != len(trace):
            raise AssertionError(f"{label}: {len(rows)} commands, the fixture has {len(trace)}")
        counts = [(r["n_vertices"], r["n_facets"]) for r in rows]
        want = [(t["n_vertices"], t["n_facets"]) for t in trace]
        if counts != want:
            raise AssertionError(f"{label}: entity counts {counts} differ from the fixture's {want}")
        devs = [abs(r["energy"] - t["energy"]) / abs(t["energy"]) for r, t in zip(rows, trace)]
        out["dev_jax"] = max(devs)
        fields["max_rel_dev_vs_jax"] = repr(out["dev_jax"])
        fields["rel_dev_vs_jax_per_command"] = json.dumps(devs)
    f32_bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
    if f32 is not None:
        devs = [abs(a - b) / abs(b) for a, b in zip(f32["energies"], energies, strict=True)]
        out["dev_f32"] = max(devs)
        fields["max_rel_dev_f32_vs_f64"] = repr(out["dev_f32"])
        fields["f32_bound"] = repr(f32_bound)
        fields["rel_dev_f32_vs_f64_per_command"] = json.dumps(devs)
        fields["f32_connectivity_after_u_equal"] = json.dumps(
            [a == b for a, b in zip(f32["digests"], digests, strict=True)])
    say(label, **fields)
    say(label + " g1 sync sites", sites=json.dumps(sites))
    if split:
        say(label + " g1 split", **{k: f"{v:.6f}" for k, v in g1_split(torch, ctx).items()})
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if "dev_jax" in out and not out["dev_jax"] <= F64_RTOL:
        raise AssertionError(f"{label}: f64 energies deviate from the JAX fixture by {out['dev_jax']!r}")
    if "dev_f32" in out and not out["dev_f32"] <= f32_bound:
        raise AssertionError(f"{label}: f32 energies deviate from f64 by {out['dev_f32']!r}")
    return out


def thetaB_energies(trace: list, final: float) -> list:
    """Every candidate's energy, scan by scan, then the call's final energy."""
    return [c["energy"] for r in trace for c in r["candidate_energies"]] + [final]


def phase_thetaB(torch, counters, label: str, fixture: dict, mn, snap: dict, expect: tuple,
                 f64=None) -> dict:
    """The theta_B scan on kozlov L3 from a saved state, counts reset just before and read after.

    At float64 (``f64`` None) the selected theta_B and the energies are held
    against the fixture; at float32 the selections against the JAX
    package's own float32 run (the fixture's ``float32_reference``) and
    the energies against ``f64``, the float64 phase's result.
    """
    from membrane_solver_tpu_torch.device import state as tstate
    from membrane_solver_tpu_torch.runtime import tilt_optimization as topt

    proto = fixture["protocol"]
    restore(mn, snap)
    mn.global_params.update(proto["global_parameters"])
    mn.problem()  # the compile the new static options need, before the call
    mn.mesh._thetaB_scan_trace = []
    scan_s, compiles_at = [], []
    real = topt.optimize_thetaB_scalar

    def timed(minimizer, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(minimizer, **kw)
        torch.cuda.synchronize()
        scan_s.append(time.perf_counter() - t0)

    reset_counts(counters)
    compiles0 = tstate.COMPILES["compile_state"]
    topt.optimize_thetaB_scalar = timed
    try:
        t0 = time.perf_counter()
        res = mn.minimize(proto["minimize"], callback=lambda _mesh, _i: compiles_at.append(
            tstate.COMPILES["compile_state"]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        topt.optimize_thetaB_scalar = real
    launches = read_counts(counters)
    trace = mn.mesh._thetaB_scan_trace
    compiles_end = tstate.COMPILES["compile_state"]
    thetaB_after = mn.global_params.get("tilt_thetaB_value")
    if f64 is None:
        ref_trace, bound = fixture["trace"], F64_RTOL
        ref_selected = [r["selected_thetaB"] for r in ref_trace]
        ref_energies = thetaB_energies(ref_trace, fixture["energy"])
    else:
        ref_trace = f64["trace"]
        bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
        ref_selected = fixture["float32_reference"]["selected_thetaB"]
        ref_energies = f64["energies"]
    if len(trace) != len(ref_trace):
        raise AssertionError(f"{label}: {len(trace)} scans, the reference has {len(ref_trace)}")
    energies = thetaB_energies(trace, res["energy"])
    devs = [abs(a - b) / abs(b) for a, b in zip(energies, ref_energies, strict=True)]
    selected_equal = [r["selected_thetaB"] == w for r, w in zip(trace, ref_selected)]
    for k, (got, want) in enumerate(zip(trace, ref_trace)):
        say(label + " scan", iteration=got["iteration"], base=repr(got["base_thetaB"]),
            selected=repr(got["selected_thetaB"]), reference_selected=repr(ref_selected[k]),
            thetas=json.dumps([c["thetaB"] for c in got["candidate_energies"]]),
            energies=json.dumps([c["energy"] for c in got["candidate_energies"]]),
            reference_energies=json.dumps([c["energy"] for c in want["candidate_energies"]]),
            host_s=f"{scan_s[k]:.6f}")
    after_entry = compiles_end - compiles_at[0]
    out = {"launches": launches, "energies": energies, "trace": [dict(r) for r in trace],
           "max_rel_dev": max(devs), "mn": mn}
    out["snap"] = check_repeat(torch, label, mn, lambda: [float(mn.minimize(2)["energy"])])
    say(label, vertices=len(mn.mesh.vertices), iterations=res["iterations"],
        energy=repr(res["energy"]), reference_energy=repr(ref_energies[-1]),
        max_rel_dev=repr(out["max_rel_dev"]), bound=repr(bound),
        reference="the JAX fixture" if f64 is None else "the float64 phase",
        selected_equal=json.dumps(selected_equal), thetaB_after=repr(thetaB_after),
        compiles_in_call=compiles_end - compiles0, compiles_after_entry=after_entry,
        seconds=f"{seconds:.3f}", scan_host_s=json.dumps([round(x, 6) for x in scan_s]),
        launches=json.dumps(launches))
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if not all(selected_equal):
        raise AssertionError(f"{label}: selected theta_B differs from the reference: {selected_equal}")
    if not out["max_rel_dev"] <= bound:
        raise AssertionError(f"{label}: energies deviate from the reference by {out['max_rel_dev']!r}")
    if after_entry != 0 or compiles_end - compiles0 > 1:
        raise AssertionError(f"{label}: {compiles_end - compiles0} compiles in the call, "
                             f"{after_entry} after the entry enforcement")
    return out


def phase_reduced(torch, counters, label: str, fixture: dict, dtype, expect: tuple,
                  f64=None) -> dict:
    """The reduced-energy line search on kozlov L3, counts reset just before and read after.

    The fixture's protocol (five ``minimize(1)``), the determinism check
    (two ``minimize(2)`` from one saved state), then ``minimize(5)`` timed
    after two warm-up steps.  At float64 (``f64`` None) the energies and
    the accept flags are held against the fixture; at float32 the energies
    against ``f64``, the float64 phase's result, within max(2e-3, 2 x the
    JAX package's own float32 deviation).  The launches per step divide
    the counts by every ``minimize`` step the phase ran.
    """
    proto = fixture["protocol"]
    reset_counts(counters)
    mn, energies, steps, setup_s = run_protocol(torch, dtype, proto)
    accepted = [ok for ok, _step in steps]
    snap = check_repeat(torch, label, mn, lambda: [float(mn.minimize(2)["energy"])])
    mn.minimize(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mn.minimize(REDUCED_TIMED_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / max(int(res["iterations"]), 1)
    launches = read_counts(counters)
    n_steps = proto["steps"] + 2 * 2 + WARMUP_STEPS + REDUCED_TIMED_STEPS
    per_step = {k: n / n_steps for k, n in launches.items()}
    p = mn.problem()
    if (p.n_vertices, p.n_tris) != (fixture["n_vertices"], fixture["n_triangles"]):
        raise AssertionError(f"{label}: mesh size {(p.n_vertices, p.n_tris)} differs from the fixture")
    out = {"energies": energies, "accepted": accepted, "ms": ms, "launches": launches,
           "per_step": per_step, "mn": mn, "snap": snap,
           "trials_per_step": res["line_search_trials"] / max(int(res["iterations"]), 1),
           "accepted_timed": res["accepted_steps"]}
    fields = {"vertices": p.n_vertices, "triangles": p.n_tris, "setup_s": f"{setup_s:.3f}",
              "energies": json.dumps(energies), "accepted": json.dumps(accepted),
              "ms_per_step": f"{ms:.3f}", "trials_per_step": repr(out["trials_per_step"]),
              "accepted_steps_timed": f"{res['accepted_steps']}/{res['iterations']}",
              "steps_counted": n_steps, "launches": json.dumps(launches)}
    if f64 is None:
        ref = fixture["energies"]
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(energies, ref, strict=True))
        bound, reference = F64_RTOL, "the JAX fixture"
        ref_accepted = fixture["accepted"]
    else:
        ref = f64["energies"]
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(energies, ref, strict=True))
        bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
        reference, ref_accepted = "the float64 phase", fixture["float32_reference"]["accepted"]
    fields.update(reference=repr(reference), max_rel_dev=repr(out["dev"]), bound=repr(bound),
                  reference_accepted=json.dumps(ref_accepted))
    fields["syncs_per_step"], sites = count_syncs(torch, lambda: mn.minimize(1))
    say(label, **fields)
    say(label + " sync sites", sites=json.dumps(sites))
    if not all(math.isfinite(e) for e in energies):
        raise AssertionError(f"{label}: non-finite energies: {energies}")
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if f64 is None and accepted != ref_accepted:
        raise AssertionError(f"{label}: accept flags {accepted} differ from the fixture's {ref_accepted}")
    if not out["dev"] <= bound:
        raise AssertionError(f"{label}: energies deviate from {reference} by {out['dev']!r}")
    return out


def phase_console(torch, fixture: dict) -> None:
    """``python -m membrane_solver_tpu_torch`` on the card; the saved mesh re-evaluated at float64."""
    import tempfile

    from membrane_solver_tpu_torch import Minimizer, load_data, parse_geometry

    proto = fixture["protocol"]
    want = fixture["trace"][len(proto["recipe"]) - 1]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "cube_out.json"
        cmd = [sys.executable, "-m", "membrane_solver_tpu_torch", "--non-interactive", "-q",
               "-i", str(REPO / proto["mesh"]), "-o", str(out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=CONSOLE_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"console run exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        mesh = parse_geometry(load_data(out))
    energy = float(Minimizer(mesh, device=DEVICE, dtype=torch.float64, quiet=True).compute_energy())
    dev = abs(energy - want["energy"]) / abs(want["energy"])
    say("10 console", command=repr(" ".join(cmd[1:])), rc=proc.returncode, seconds=f"{seconds:.3f}",
        vertices=len(mesh.vertices), facets=len(mesh.facets), energy=repr(energy),
        want=repr(want["energy"]), rel_dev=repr(dev))
    if (len(mesh.vertices), len(mesh.facets)) != (want["n_vertices"], want["n_facets"]):
        raise AssertionError(f"console run saved {len(mesh.vertices)} vertices, "
                             f"{len(mesh.facets)} facets; want {want}")
    if not dev <= F64_RTOL:
        raise AssertionError(f"console run's energy {energy!r} deviates from {want['energy']!r}")


def kernels_line(kern: dict, runs: dict) -> list:
    """The ``{"kernels": [...]}`` entries: one per entry point, every key filled."""
    out = []
    for name, (source, replaces, row, counter) in KERNELS.items():
        timing = kern["timing"]
        k_row, twin = timing[(row, "kernel")], timing[(row, "twin")]
        library = timing.get((row, "library"))
        out.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": "membrane_solver_tpu/" + replaces,
            "launches": sum(run["launches"][counter] for run in runs.values()),
            "max_abs_err": max(kern["errs"][k] for k in ERRORS[name]),
            "ms": k_row["device_ms"], "plain_ms": twin["device_ms"],
            "bound_ms": k_row["bound_ms"], "bound_by": k_row["bound_by"],
            "library_ms": None if library is None else library["device_ms"],
            "event_ms": k_row["event_ms"], "host_us": k_row["host_us"],
        })
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    kozlov = load_fixture(KOZLOV_FIXTURE)
    vesicle = load_fixture(VESICLE_FIXTURE)
    cube_cli = json.loads(CUBE_CLI_FIXTURE.read_text())
    square = json.loads(SQUARE_FIXTURE.read_text())
    rect = json.loads(RECT_FIXTURE.read_text())
    thetaB = json.loads(THETAB_FIXTURE.read_text())
    reduced = load_fixture(REDUCED_FIXTURE)
    device = phase_device(torch)
    phase_build((ft, tk, vs))
    kern = phase_kernels(torch, (ft, tk, vs),
                         build_lane(torch, kozlov["protocol"], torch.float64).problem(),
                         build_lane(torch, vesicle["protocol"], torch.float64).problem())

    counters = {"frozen_tilt": ft.LAUNCHES, "tri_kernels": tk.LAUNCHES,
                "vertex_sum": vs.LAUNCHES}
    shared = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
              "tri_kernels.curvature_data", "tri_kernels.curvature_data_bwd",
              "vertex_sum.vertex_sum")
    kozlov_path = shared + ("tri_kernels.p1_div",)
    runs = {}
    runs["k32"] = phase_path(torch, counters, "4 kozlov_L3 f32", kozlov, torch.float32,
                             kozlov_path + ("frozen_tilt.energy", "frozen_tilt.energy_grad"))
    runs["k64"] = phase_path(torch, counters, "5 kozlov_L3 f64", kozlov, torch.float64,
                             kozlov_path, f32_energies=runs["k32"]["energies"])
    check_tri_sets(torch, tk, "5 kozlov_L3 tri kernels", kozlov_triangles(torch, runs["k64"]["mn"]),
                   kern["errs"])
    runs["v32"] = phase_path(torch, counters, "6 helfrich_cube_L5 f32", vesicle, torch.float32,
                             shared)
    runs["v64"] = phase_path(torch, counters, "7 helfrich_cube_L5 f64", vesicle, torch.float64,
                             shared, f32_energies=runs["v32"]["energies"])
    cli_path = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
                "tri_kernels.curvature_data", "vertex_sum.vertex_sum")
    runs["c32"] = phase_cli(torch, counters, "8 cube_cli_L5 f32", cube_cli, torch.float32,
                            cli_path)
    runs["c64"] = phase_cli(torch, counters, "9 cube_cli_L5 f64", cube_cli, torch.float64,
                            cli_path, f32=runs["c32"])
    phase_console(torch, cube_cli)
    square_path = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
                   "vertex_sum.vertex_sum")
    runs["s32"] = phase_cli(torch, counters, "11 square_to_circle_L1 f32", square, torch.float32,
                            square_path)
    runs["s64"] = phase_cli(torch, counters, "12 square_to_circle_L1 f64", square, torch.float64,
                            square_path, f32=runs["s32"])
    check_area_calls(torch, tk, "12 square_to_circle_L1 area calls", runs["s64"]["mn"].problem(),
                     kern["errs"])
    rect_path = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
                 "tri_kernels.curvature_data", "vertex_sum.vertex_sum")
    runs["r32"] = phase_cli(torch, counters, "13 rect_tilt_source_L0 f32", rect, torch.float32,
                            rect_path, split=True)
    runs["r64"] = phase_cli(torch, counters, "14 rect_tilt_source_L0 f64", rect, torch.float64,
                            rect_path, f32=runs["r32"], split=True)
    for key in ("r32", "r64"):
        if runs[key]["launches"]["tri_kernels.curvature_data_bwd"]:
            raise AssertionError(f"the rect lane ran the curvature backward: {runs[key]['launches']}")
    check_tri_sets(torch, tk, "14 rect_tilt_source_L0 tri kernels",
                   sheet_triangles(runs["r64"]["mn"].problem()), kern["errs"])
    runs["t64"] = phase_thetaB(torch, counters, "15 kozlov_L3_thetaB f64", thetaB,
                               runs["k64"]["mn"], runs["k64"]["snap"], kozlov_path)
    runs["t32"] = phase_thetaB(torch, counters, "15 kozlov_L3_thetaB f32", thetaB,
                               runs["k32"]["mn"], runs["k32"]["snap"],
                               kozlov_path + ("frozen_tilt.energy", "frozen_tilt.energy_grad"),
                               f64=runs["t64"])
    # the frozen-tilt kernel inside every line-search trial's relax at float32
    t_reduced = time.perf_counter()
    runs["d64"] = phase_reduced(torch, counters, "16 kozlov_L3_reduced f64", reduced,
                                torch.float64, kozlov_path)
    runs["d32"] = phase_reduced(torch, counters, "17 kozlov_L3_reduced f32", reduced,
                                torch.float32,
                                kozlov_path + ("frozen_tilt.energy", "frozen_tilt.energy_grad"),
                                f64=runs["d64"])
    say("16-17 kozlov_L3_reduced", seconds=f"{time.perf_counter() - t_reduced:.3f}")
    k_steps = kozlov["protocol"]["steps"] + 2 * 2 + WARMUP_STEPS + TIMED_STEPS
    for key in ("frozen_tilt.energy", "frozen_tilt.energy_grad"):
        plain, inside = runs["k32"]["launches"][key] / k_steps, runs["d32"]["per_step"][key]
        say("17 kozlov_L3_reduced f32 frozen tilt", kernel=key, per_step=repr(inside),
            phase_4_per_step=repr(plain))
        if not inside > plain:
            raise AssertionError(f"{key}: {inside} launches per step in the reduced line search, "
                                 f"not above phase 4's {plain}")
    # phases 8-10 have imported the CLI and the command layer by now
    if not {"membrane_solver_tpu_torch.cli", "membrane_solver_tpu_torch.commands"} <= set(sys.modules):
        raise AssertionError("the CLI and the command layer were not imported")
    if "jax" in sys.modules or any(m.split(".")[0] == "membrane_solver_tpu" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    say("total", seconds=f"{time.perf_counter() - t_start:.3f}")
    print(json.dumps({"kernels": kernels_line(kern, runs)}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
