#!/usr/bin/env python3
"""Smoke run of the PyTorch port (membrane_solver_tpu_torch) on one NVIDIA GPU.

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No CUDA device -> exit 2 before anything else.
2. build: compiles the CUDA sources of ``membrane_solver_tpu_torch/csrc``
   (``frozen_tilt.cu``, ``tri_kernels.cu``) with nvcc, one process per
   source, all started together; prints the seconds taken and the ptxas
   report.
3. kernels: every kernel against its plain PyTorch twin on the card, with
   median CUDA-event times of kernel and twin:
   - frozen-tilt forward and gradient, float32, seeded inputs at T = 301 and
     T = 21,504: energy to rel 1e-6, gradient to 5e-6 * max|g|;
   - the four per-triangle kernels (surface, curvature forward and
     backward, P1 divergence), float32 and float64, on seeded triangles
     (T = 301) and on the vesicle lane's own 24,576 triangles (the lane's
     start positions plus a seeded 1e-3 perturbation): float32 to the JAX
     kernel tests' bounds (surface e rel 2e-6 / atol 1e-7, corner gradients
     rel 2e-5 / atol 1e-6, curvature and divergence rel 5e-5 / atol 1e-5,
     curvature backward 5e-5 * max|g|), float64 to 1e-12 * max(|want|, 1)
     (curvature backward 1e-11 * max|g|).  Curvature rows within 1e-6 of a
     Meyer branch tie (a cotangent at 0) are left out: there the two sides
     may take different branches.
4. kozlov L3, float32: the kozlov coupled-tilt protocol that its fixture's
   ``protocol`` block records (meshgen ``kozlov_1disk`` with the bench
   global parameters -> three refinement rounds -> 10,817 vertices, 21,504
   triangles -> five ``minimize(1)`` calls), then ``minimize(2)`` as warm-up
   and ``minimize(10)`` timed.  Every energy must be finite and the last
   below the first.  Host syncs of one step are counted with
   ``torch.cuda.set_sync_debug_mode``.
5. kozlov L3, float64: the same protocol; its five energies must match the
   JAX package's recorded trajectory
   (``tests/fixtures/torch_port/kozlov_L3_f64_jax.json``) to rel 1e-8, and
   the float32 energies of phase 4 must lie within rel 2e-3 of them.  Then
   the four per-triangle kernels against their twins, at float32 and
   float64 with phase 3's tolerances, on this lane's own 21,504 triangles
   as the run left them: one set per leaflet, with that leaflet's tilts and
   the ``tri_valid & tri_present`` mask its bending-tilt curvature call
   takes.
6. helfrich_cube L5, float32: the Helfrich vesicle protocol of
   ``helfrich_cube_L5_f64_jax.json`` (meshgen cube, surface + Helfrich
   bending, hard volume constraint -> polygonal refine and five triangle
   refines -> 12,290 vertices, 24,576 triangles -> five ``minimize(1)``
   calls at the adaptive step), then 2 warm-up and 10 timed steps.
7. helfrich_cube L5, float64: the same; rel 1e-8 against the JAX fixture,
   and phase 6's energies within rel 2e-3 of these.

Phases 4-7 each drive one path with every kernel launch counter set to 0
just before and read just after; a kernel of that path that was never
launched fails the run (the frozen-tilt kernels lie on the float32 kozlov
path only; the per-triangle surface and curvature kernels on all four; the
divergence kernel on the kozlov paths).

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
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
KOZLOV_FIXTURE = FIXTURES / "kozlov_L3_f64_jax.json"
VESICLE_FIXTURE = FIXTURES / "helfrich_cube_L5_f64_jax.json"
FT_SOURCE = "membrane_solver_tpu_torch/csrc/frozen_tilt.cu"
TK_SOURCE = "membrane_solver_tpu_torch/csrc/tri_kernels.cu"
# the Pallas kernel bodies these replace (_fwd_kernel, _bwd_kernel), both
# launched through the pallas_call at frozen_tilt.py:186
REPLACES_FWD = "membrane_solver_tpu/pallas_kernels/frozen_tilt.py:83"
REPLACES_BWD = "membrane_solver_tpu/pallas_kernels/frozen_tilt.py:111"
# tri_kernels.py: _surface_kernel, _curvature_kernel, curvature_corners_pallas
# (whose backward JAX takes from the stock geo.curvature_data; the Pallas
# kernel has none), _p1_div_kernel
TK_REPLACES = {
    "surface_fwd": "membrane_solver_tpu/pallas_kernels/tri_kernels.py:80",
    "curvature_fwd": "membrane_solver_tpu/pallas_kernels/tri_kernels.py:143",
    "curvature_bwd": "membrane_solver_tpu/pallas_kernels/tri_kernels.py:193",
    "p1_div_fwd": "membrane_solver_tpu/pallas_kernels/tri_kernels.py:228",
}

DEVICE = "cuda"
WARMUP_STEPS = 2
TIMED_STEPS = 10

ENERGY_RTOL = 1e-6  # frozen-tilt kernel vs twin energy (f32 reduction order)
GRAD_RTOL = 5e-6  # frozen-tilt kernel vs twin gradient, relative to max|g|
F64_RTOL = 1e-8  # f64 trajectory vs the JAX fixture (CUDA scatter order)
F32_RTOL = 2e-3  # f32 vs f64 trajectory
# per-triangle kernels vs twins: (rtol, atol) elementwise at float32 (the JAX
# kernel tests' bounds), rtol of max(|want|, 1) at float64
TK_F32 = {"e": (2e-6, 1e-7), "g": (2e-5, 1e-6), "curv": (5e-5, 1e-5)}
TK_F64 = 1e-12
TK_BWD = {"float32": 5e-5, "float64": 1e-11}  # of max|g|
TIE = 1e-6  # |cot| below this: a Meyer branch tie


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


def phase_build(ft, tk) -> None:
    from membrane_solver_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(ft.KERNEL, tk.KERNEL)  # one nvcc per source, in parallel
    ft.build()
    tk.build()
    seconds = time.perf_counter() - t0
    say("2 build", seconds=f"{seconds:.3f}",
        libraries=",".join(k.library_path().name for k in (ft.KERNEL, tk.KERNEL)))
    for kernel in (ft.KERNEL, tk.KERNEL):
        for ln in kernel.log().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                say("2 build ptxas", source=kernel.name, line=repr(ln.strip()))


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
    """Frozen-tilt kernel vs twin on the card; returns errors and times at the largest T."""
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


# ----------------------------------------------------------------------
# the per-triangle kernels against their twins
# ----------------------------------------------------------------------
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


def _lane_triangles(torch, seed: int):
    """The vesicle lane's own triangles: its start positions, perturbed by 1e-3, as numpy."""
    mn = build_lane(torch, load_fixture(VESICLE_FIXTURE)["protocol"], torch.float64)
    p = mn.problem()
    rng = np.random.default_rng(seed)
    pos = p.state.positions.cpu().numpy()
    pos = pos + 1e-3 * rng.standard_normal(pos.shape)
    rows = p.topo.tri_rows.cpu().numpy()
    return pos, rows, p.topo.tri_valid.cpu().numpy(), 0.3 * rng.standard_normal(pos.shape)


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


def check_tri_kernels(torch, tk, arrays, dtype, seed: int) -> dict:
    """The four per-triangle kernels vs their twins on one input set; max abs errors."""
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.device import tilt_ops

    pos, rows, valid, tilts = arrays
    dev = DEVICE
    p = torch.as_tensor(pos, dtype=dtype, device=dev)
    t_rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    v = torch.as_tensor(valid, device=dev)
    tl = torch.as_tensor(tilts, dtype=dtype, device=dev)
    T = t_rows.shape[0]
    corners = [p[t_rows[:, i]] for i in range(3)]
    errs = {}

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
    bwd_err = float(torch.max(torch.abs(dp[clear] - want[clear])))
    scale = float(torch.max(torch.abs(want[clear])))
    if not bwd_err <= TK_BWD[str(dtype).removeprefix("torch.")] * scale:
        raise AssertionError(f"curvature bwd ({dtype}): max abs err {bwd_err!r}, max|g| {scale!r}")
    errs["curvature_bwd"] = bwd_err

    div, area, g = tk.launch_p1_div(p, tl, t_rows)
    want = tilt_ops.p1_divergence_corners(*corners, *[tl[t_rows[:, i]] for i in range(3)])
    errs["p1_div_fwd"] = max(
        _tk_check(torch, "p1 div", div, want[0], dtype, "curv"),
        _tk_check(torch, "p1 area", area, want[1], dtype, "curv"),
        _tk_check(torch, "p1 g", g, torch.stack(want[2:], 1), dtype, "curv"),
    )
    torch.cuda.synchronize()
    return errs, int(T - int(torch.sum(clear)))


def time_tri_kernels(torch, tk, arrays, dtype) -> dict:
    """Median CUDA-event ms of each kernel and of its twin (corner gathers included)."""
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.device import tilt_ops

    pos, rows, valid, tilts = arrays
    p = torch.as_tensor(pos, dtype=dtype, device=DEVICE)
    t_rows = torch.as_tensor(rows, dtype=torch.int64, device=DEVICE)
    v = torch.as_tensor(valid, device=DEVICE)
    tl = torch.as_tensor(tilts, dtype=dtype, device=DEVICE)
    gamma = torch.where(v, 1.0, 0.0).to(dtype)
    T = t_rows.shape[0]
    cts = [torch.ones(s, dtype=dtype, device=DEVICE) for s in ((T, 3), (T, 3, 3), (T, 3), (T,))]

    def corners(x):
        return [x[t_rows[:, i]] for i in range(3)]

    pairs = {
        "surface_fwd": (lambda: tk.launch_surface(p, t_rows, gamma),
                        lambda: dgeo.surface_corner_terms(*corners(p), gamma)),
        "curvature_fwd": (lambda: tk.launch_curvature(p, t_rows, v),
                          lambda: dgeo.curvature_corners(*corners(p), v)),
        "curvature_bwd": (lambda: tk.launch_curvature_bwd(p, t_rows, v, *cts),
                          lambda: tk.curvature_corners_vjp(p, t_rows, v, *cts)),
        "p1_div_fwd": (lambda: tk.launch_p1_div(p, tl, t_rows),
                       lambda: tilt_ops.p1_divergence_corners(*corners(p), *corners(tl))),
    }
    return {name: (_median_ms(torch, kern), _median_ms(torch, twin))
            for name, (kern, twin) in pairs.items()}


def check_tri_sets(torch, tk, phase: str, sets, errs_out: dict) -> None:
    """check_tri_kernels at float32 and float64 on each (label, arrays, seed); folds max errors."""
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        for label, arrays, seed in sets:
            errs, ties = check_tri_kernels(torch, tk, arrays, dtype, seed)
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
                     (pos, rows, keep.cpu().numpy(), tilts.detach().cpu().numpy()), 19))
    return sets


def phase_tri_kernels(torch, tk) -> dict:
    lane = _lane_triangles(torch, seed=17)
    out = {"errs": {}, "ms": {}}
    check_tri_sets(torch, tk, "3 tri kernels", (("T=301", _seeded_triangles(301, 7), 7),
                                                (f"lane T={lane[1].shape[0]}", lane, 17)),
                   out["errs"])
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        times = time_tri_kernels(torch, tk, lane, dtype)
        say("3 tri kernels timing", dtype=name, T=lane[1].shape[0],
            **{f"{k}_ms": f"{a:.6f}/{b:.6f}" for k, (a, b) in times.items()})
        out["ms"][name] = times
    return out


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


def reset_counts(counters) -> None:
    for launches in counters.values():
        for key in launches:
            launches[key] = 0


def read_counts(counters) -> dict:
    return {f"{mod}.{key}": n for mod, launches in counters.items() for key, n in launches.items()}


def phase_path(torch, counters, label: str, fixture: dict, dtype, expect: tuple,
               f32_energies=None) -> dict:
    """Drive one lane at one dtype with the launch counts reset just before and read just after."""
    reset_counts(counters)
    mn, energies, steps, setup_s = run_protocol(torch, dtype, fixture["protocol"])
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
    out = {"energies": energies, "ms": ms, "launches": launches, "mn": mn}
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
    fields["syncs_per_step"] = count_syncs(torch, mn)
    say(label, **fields)
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if "dev_jax" in out and not out["dev_jax"] <= F64_RTOL:
        raise AssertionError(f"{label}: f64 trajectory deviates from the JAX fixture by {out['dev_jax']!r}")
    if "dev_f32" in out and not out["dev_f32"] <= F32_RTOL:
        raise AssertionError(f"{label}: f32 trajectory deviates from f64 by {out['dev_f32']!r}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    kozlov = load_fixture(KOZLOV_FIXTURE)
    vesicle = load_fixture(VESICLE_FIXTURE)
    device = phase_device(torch)
    phase_build(ft, tk)
    kern = phase_kernels(torch, ft)
    tri = phase_tri_kernels(torch, tk)

    counters = {"frozen_tilt": ft.LAUNCHES, "tri_kernels": tk.LAUNCHES}
    tri_all = tuple(f"tri_kernels.{k}" for k in tk.LAUNCHES)
    tri_vesicle = ("tri_kernels.surface_fwd", "tri_kernels.curvature_fwd",
                   "tri_kernels.curvature_bwd")
    runs = {}
    runs["k32"] = phase_path(torch, counters, "4 kozlov_L3 f32", kozlov, torch.float32,
                             ("frozen_tilt.fwd", "frozen_tilt.bwd") + tri_all)
    runs["k64"] = phase_path(torch, counters, "5 kozlov_L3 f64", kozlov, torch.float64, tri_all,
                             f32_energies=runs["k32"]["energies"])
    check_tri_sets(torch, tk, "5 kozlov_L3 tri kernels", kozlov_triangles(torch, runs["k64"]["mn"]),
                   tri["errs"])
    runs["v32"] = phase_path(torch, counters, "6 helfrich_cube_L5 f32", vesicle, torch.float32,
                             tri_vesicle)
    runs["v64"] = phase_path(torch, counters, "7 helfrich_cube_L5 f64", vesicle, torch.float64,
                             tri_vesicle, f32_energies=runs["v32"]["energies"])
    if "jax" in sys.modules or any(m.split(".")[0] == "membrane_solver_tpu" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    def launches(key):
        return sum(run["launches"][key] for run in runs.values())

    kernels = [
        {"name": "frozen_tilt_energy", "route": "cuda", "source": FT_SOURCE,
         "replaces": REPLACES_FWD, "launches": launches("frozen_tilt.fwd"),
         "max_abs_err": kern["energy_abs_err"], "ms": kern["kernel_fwd_ms"],
         "plain_ms": kern["twin_fwd_ms"]},
        {"name": "frozen_tilt_grad", "route": "cuda", "source": FT_SOURCE,
         "replaces": REPLACES_BWD, "launches": launches("frozen_tilt.bwd"),
         "max_abs_err": kern["grad_abs_err"], "ms": kern["kernel_bwd_ms"],
         "plain_ms": kern["twin_grads_ms"]},
    ]
    for name, replaces in TK_REPLACES.items():
        ms, plain_ms = tri["ms"]["float32"][name]
        kernels.append({"name": f"tri_{name}", "route": "cuda", "source": TK_SOURCE,
                        "replaces": replaces, "launches": launches(f"tri_kernels.{name}"),
                        "max_abs_err": tri["errs"][name], "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
