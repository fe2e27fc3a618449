#!/usr/bin/env python3
"""Smoke run of the PyTorch port (membrane_solver_tpu_torch) on one NVIDIA GPU.

Phases, each printing its own line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No CUDA device -> exit 2 before anything else.
2. build: compiles the CUDA kernels from ``membrane_solver_tpu_torch/csrc``
   with nvcc and prints the seconds taken and the ptxas report.
3. kernels: every kernel of the main path against its plain PyTorch twin on
   the card, float32, seeded inputs at T = 301 and T = 21,504 triangles:
   energy to rel 1e-6, gradient to 5e-6 * max|g|.  Median CUDA-event times
   of kernel and twin at T = 21,504.
4. main path, float32: the kozlov coupled-tilt protocol that the fixture's
   ``protocol`` block records (meshgen ``kozlov_1disk`` with the bench
   global parameters -> three refinement rounds -> 10,817 vertices, 21,504
   triangles -> five ``minimize(1)`` calls), then ``minimize(2)`` as warm-up
   and ``minimize(10)`` timed.  The kernels' launch counters are reset just
   before and must have grown; every energy must be finite and the last
   below the first.  Host syncs of one step are counted with
   ``torch.cuda.set_sync_debug_mode``.
5. main path, float64: the same protocol; its five energies must match the
   JAX package's recorded trajectory
   (``tests/fixtures/torch_port/kozlov_L3_f64_jax.json``) to rel 1e-8, and
   the float32 energies of phase 4 must lie within rel 2e-3 of them.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_port" / "kozlov_L3_f64_jax.json"
KERNEL_SOURCE = "membrane_solver_tpu_torch/csrc/frozen_tilt.cu"
# the Pallas kernel bodies these replace (_fwd_kernel, _bwd_kernel), both
# launched through the pallas_call at frozen_tilt.py:186
REPLACES_FWD = "membrane_solver_tpu/pallas_kernels/frozen_tilt.py:83"
REPLACES_BWD = "membrane_solver_tpu/pallas_kernels/frozen_tilt.py:111"

WARMUP_STEPS = 2
TIMED_STEPS = 10

ENERGY_RTOL = 1e-6  # kernel vs twin energy (f32 reduction order)
GRAD_RTOL = 5e-6  # kernel vs twin gradient, relative to max|g|
F64_RTOL = 1e-8  # f64 trajectory vs the JAX fixture (CUDA scatter order)
F32_RTOL = 2e-3  # f32 vs f64 trajectory


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    say("1 device", name=repr(device["kind"]), count=device["count"],
        torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    return device


def phase_build(ft) -> None:
    t0 = time.perf_counter()
    ft.build()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in ft.build_log().splitlines() if "registers" in ln or "spill" in ln]
    say("2 build", seconds=f"{seconds:.3f}", library=ft.library_path().name)
    for ln in ptxas:
        say("2 build ptxas", line=repr(ln))


def _inputs(torch, T: int, seed: int):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrays = (
        rng.standard_normal((T, 3, 3)).astype(f32),
        rng.standard_normal((T, 3, 3)).astype(f32),
        rng.standard_normal((T, 3, 3)).astype(f32),
        np.abs(rng.standard_normal((T, 20))).astype(f32),
        rng.uniform(0.5, 2.0, 6).astype(f32),
    )
    return [torch.from_numpy(a).cuda() for a in arrays]


def _median_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(torch, ft) -> dict:
    """Kernel vs twin on the card; returns errors and times at the largest T."""
    out = {}
    for T, seed in ((301, 7), (21_504, 13)):
        tin, tout, g, pay, k = _inputs(torch, T, seed)
        e_kernel = float(ft.fused_tilt_energy(tin, tout, g, pay, k))
        e_twin = float(ft.reference_energy(tin, tout, g, pay, k))
        e_err = abs(e_kernel - e_twin)
        if not (math.isfinite(e_kernel) and e_err <= ENERGY_RTOL * abs(e_twin)):
            raise AssertionError(f"T={T}: kernel energy {e_kernel!r} vs twin {e_twin!r}")

        a = tin.clone().requires_grad_(True)
        b = tout.clone().requires_grad_(True)
        gk = torch.autograd.grad(ft.fused_tilt_energy(a, b, g, pay, k), (a, b))
        ga = torch.autograd.grad(ft.reference_energy(a, b, g, pay, k), (a, b))
        gt = ft.reference_grads(tin, tout, g, pay, k)
        g_err = 0.0
        for got, want_ad, want_twin in zip(gk, ga, gt):
            scale = float(torch.max(torch.abs(want_ad)))
            err = max(float(torch.max(torch.abs(got - want_ad))),
                      float(torch.max(torch.abs(got - want_twin))))
            if not err <= GRAD_RTOL * scale:
                raise AssertionError(f"T={T}: kernel gradient error {err!r} > {GRAD_RTOL} * {scale!r}")
            g_err = max(g_err, err)
        torch.cuda.synchronize()
        say("3 kernels", T=T, energy_abs_err=repr(e_err), energy_rel_err=repr(e_err / abs(e_twin)),
            grad_max_abs_err=repr(g_err))
        out = {"T": T, "energy_abs_err": e_err, "grad_abs_err": g_err}

    ones = torch.ones((), dtype=torch.float32, device="cuda")

    def twin_fwd_bwd():
        a = tin.detach().requires_grad_(True)
        b = tout.detach().requires_grad_(True)
        torch.autograd.grad(ft.reference_energy(a, b, g, pay, k), (a, b))

    times = {
        "kernel_fwd_ms": _median_ms(torch, lambda: ft.launch_energy(tin, tout, g, pay, k)),
        "kernel_bwd_ms": _median_ms(torch, lambda: ft.launch_grads(tin, tout, g, pay, k, ones)),
        "twin_fwd_ms": _median_ms(torch, lambda: ft.reference_energy(tin, tout, g, pay, k)),
        "twin_grads_ms": _median_ms(torch, lambda: ft.reference_grads(tin, tout, g, pay, k)),
        "twin_fwd_bwd_ms": _median_ms(torch, twin_fwd_bwd),
    }
    say("3 kernels timing", T=out["T"], **{k_: f"{v:.6f}" for k_, v in times.items()})
    out.update(times)
    return out


def load_fixture() -> dict:
    """The JAX trajectory and the protocol it was recorded with.

    The fixture's ``protocol`` block (global parameters, step size, refinement
    rounds, steps) is what ``run_protocol`` runs, so the two cannot drift.
    """
    fixture = json.loads(FIXTURE.read_text())
    proto = fixture["protocol"]
    if (proto["mesh"], proto["dtype"]) != ("meshgen kozlov_1disk", "float64"):
        raise AssertionError(f"unexpected fixture protocol: {proto}")
    if len(fixture["energies"]) != proto["steps"] or proto["steps"] < 2:
        raise AssertionError(f"fixture holds {len(fixture['energies'])} energies for {proto['steps']} steps")
    return fixture


def run_protocol(torch, dtype, protocol: dict):
    """The fixture's protocol on the card; returns (minimizer, per-step energies, set-up s)."""
    from membrane_solver_tpu_torch import Minimizer, parse_geometry
    from membrane_solver_tpu_torch.meshgen import build
    from membrane_solver_tpu_torch.runtime.refinement import (
        refine_polygonal_facets,
        refine_triangle_mesh,
    )

    t0 = time.perf_counter()
    mesh = parse_geometry(build("kozlov_1disk"))
    mesh.global_parameters.update(protocol["global_parameters"])
    mn = Minimizer(mesh, device="cuda", dtype=dtype, quiet=True)
    mn.step_size = protocol["step_size"]
    for _ in range(protocol["refines"]):
        m = refine_polygonal_facets(mn.mesh)
        m = refine_triangle_mesh(m)
        mn.mesh = m
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    setup_s = time.perf_counter() - t0
    energies = [float(mn.minimize(1)["energy"]) for _ in range(protocol["steps"])]
    return mn, energies, setup_s


def timed_steps(torch, mn) -> float:
    mn.minimize(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mn.minimize(TIMED_STEPS)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / max(int(res["iterations"]), 1)


def count_syncs(torch, mn) -> int:
    """Synchronizing CUDA operations in one minimize(1) call."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mn.minimize(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def phase_f32(torch, ft, fixture) -> dict:
    for key in ft.LAUNCHES:
        ft.LAUNCHES[key] = 0
    mn, energies, setup_s = run_protocol(torch, torch.float32, fixture["protocol"])
    ms = timed_steps(torch, mn)
    launches = dict(ft.LAUNCHES)
    p = mn.problem()
    if (p.n_vertices, p.n_tris) != (fixture["n_vertices"], fixture["n_triangles"]):
        raise AssertionError(f"mesh size {(p.n_vertices, p.n_tris)} differs from the fixture")
    if not all(math.isfinite(e) for e in energies) or not energies[-1] < energies[0]:
        raise AssertionError(f"f32 energies not finite and descending: {energies}")
    if not (launches["fwd"] > 0 and launches["bwd"] > 0):
        raise AssertionError(f"the main path did not launch every kernel: {launches}")
    syncs = count_syncs(torch, mn)
    say("4 main f32", vertices=p.n_vertices, triangles=p.n_tris, setup_s=f"{setup_s:.3f}",
        energies=json.dumps(energies), ms_per_step=f"{ms:.3f}", launches=json.dumps(launches),
        syncs_per_step=syncs)
    return {"energies": energies, "ms": ms, "launches": launches}


def phase_f64(torch, fixture, f32_energies) -> None:
    mn, energies, setup_s = run_protocol(torch, torch.float64, fixture["protocol"])
    ref = fixture["energies"]
    dev_jax = max(abs(a - b) / abs(b) for a, b in zip(energies, ref, strict=True))
    dev_f32 = max(abs(a - b) / abs(b) for a, b in zip(f32_energies, energies, strict=True))
    ms = timed_steps(torch, mn)
    say("5 main f64", setup_s=f"{setup_s:.3f}", energies=json.dumps(energies),
        max_rel_dev_vs_jax=repr(dev_jax), max_rel_dev_f32_vs_f64=repr(dev_f32),
        ms_per_step=f"{ms:.3f}", syncs_per_step=count_syncs(torch, mn))
    if not dev_jax <= F64_RTOL:
        raise AssertionError(f"f64 trajectory deviates from the JAX fixture by {dev_jax!r}")
    if not dev_f32 <= F32_RTOL:
        raise AssertionError(f"f32 trajectory deviates from f64 by {dev_f32!r}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    fixture = load_fixture()
    device = phase_device(torch)
    phase_build(ft)
    kern = phase_kernels(torch, ft)
    f32 = phase_f32(torch, ft, fixture)
    phase_f64(torch, fixture, f32["energies"])
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    kernels = [
        {"name": "frozen_tilt_energy", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES_FWD, "launches": f32["launches"]["fwd"],
         "max_abs_err": kern["energy_abs_err"], "ms": kern["kernel_fwd_ms"],
         "plain_ms": kern["twin_fwd_ms"]},
        {"name": "frozen_tilt_grad", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES_BWD, "launches": f32["launches"]["bwd"],
         "max_abs_err": kern["grad_abs_err"], "ms": kern["kernel_bwd_ms"],
         "plain_ms": kern["twin_grads_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
