#!/usr/bin/env python3
"""Where the time of one outer step goes: the PyTorch port, one GPU.

For each lane that ``chip_smoke.py`` runs (kozlov L3, then the Helfrich
vesicle helfrich_cube L5) and for float32 and then float64, in one process
on one card:

1. the lane's protocol as its JAX fixture's ``protocol`` block records it
   (kozlov: ``kozlov_1disk``, bench global parameters, three refinement
   rounds; vesicle: meshgen cube, surface + bending + hard volume, five
   refinement rounds; then five ``minimize(1)`` calls), then 2 warm-up
   steps;
2. unprofiled ms/step: host clock around ``minimize(10)``, a device sync on
   both sides; every hand kernel's launches per step over that run;
3. synced split: the layers of an outer step (tilt relax, where the lane
   has tilts; energy and shape gradient; KKT projection; line search) each
   wrapped in device syncs and timed on the host clock over 5 steps.  The
   syncs add their own cost, so these rows compare only with each other;
4. ``torch.profiler`` over 3 unsynced steps: device-side operations (kernels
   and copies) per step, device busy ms per step (the sum of their device
   time; one stream, so they do not overlap), the busy share against the
   profiled wall time and against step 2's unprofiled ms/step, and the
   operations with the most device time;
5. host syncs in one step (``torch.cuda.set_sync_debug_mode``), with the
   source lines that issued them.

Prints one summary line per dtype and, last, one JSON object with every
number; ``-o FILE`` also writes the full report (top operations) there.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 tools/profile_torch_port.py [-o FILE]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TIMED_STEPS = 10
SPLIT_STEPS = 5
PROFILED_STEPS = 3
TOP_OPS = 12


@contextlib.contextmanager
def synced_split(torch, totals: dict):
    """Time the four layers of ``jit_core.minimize_block`` with device syncs.

    ``minimize_block`` looks its layer factories up on the module each time a
    block is built, so wrapping them there reaches every ``minimize`` call
    made inside the ``with``.
    """
    from membrane_solver_tpu_torch.runtime import jit_core

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] += (time.perf_counter() - t0) * 1e3
            return out

        return run

    names = ("make_guarded_relax", "make_energy_vg", "make_gradient_projector",
             "armijo_line_search")
    orig = {n: getattr(jit_core, n) for n in names}

    def projector(spec):
        p = orig["make_gradient_projector"](spec)
        return None if p is None else timed("kkt_project", p)

    jit_core.make_guarded_relax = lambda spec: timed("relax", orig["make_guarded_relax"](spec))
    jit_core.make_energy_vg = lambda spec: timed("energy_vg", orig["make_energy_vg"](spec))
    jit_core.make_gradient_projector = projector
    jit_core.armijo_line_search = timed("line_search", orig["armijo_line_search"])
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(jit_core, n, fn)


def device_profile(torch, mn):
    """(profiled wall ms/step, device ops/step, busy ms/step, top ops) over unsynced steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = int(mn.minimize(PROFILED_STEPS)["iterations"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        raise RuntimeError("the profiler recorded no device-side operation")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:TOP_OPS]
    top = [(e.self_device_time_total / 1e3 / n, e.count / n, e.key) for e in top]
    return wall_ms / n, sum(e.count for e in rows) / n, busy_ms / n, top


def profile_dtype(torch, chip_smoke, counters, fixture, dtype, lane) -> tuple[dict, list[str]]:
    mn, _energies, _steps, setup_s = chip_smoke.run_protocol(torch, dtype, fixture["protocol"])
    mn.minimize(chip_smoke.WARMUP_STEPS)

    chip_smoke.reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = int(mn.minimize(TIMED_STEPS)["iterations"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    launches = {k: v / n for k, v in chip_smoke.read_counts(counters).items()}

    totals = collections.defaultdict(float)
    with synced_split(torch, totals):
        t0 = time.perf_counter()
        n_split = int(mn.minimize(SPLIT_STEPS)["iterations"])
        torch.cuda.synchronize()
        split_wall = (time.perf_counter() - t0) * 1e3 / n_split
    split = {k: v / n_split for k, v in totals.items()}

    prof_wall, ops, busy, top = device_profile(torch, mn)
    syncs, sync_sites = chip_smoke.count_syncs(torch, mn)

    name = f"{lane} {str(dtype).removeprefix('torch.')}"
    rec = {
        "setup_s": setup_s,
        "ms_per_step": ms,
        "kernel_launches_per_step": launches,
        "synced_wall_ms_per_step": split_wall,
        "synced_split_ms_per_step": split,
        "profiled_wall_ms_per_step": prof_wall,
        "device_ops_per_step": ops,
        "device_busy_ms_per_step": busy,
        "busy_share_of_profiled_wall": busy / prof_wall,
        "busy_share_of_unprofiled_step": busy / ms,
        "host_syncs_per_step": syncs,
        "host_sync_sites": sync_sites,
    }
    report = [f"[{name}] " + json.dumps(rec)]
    report += [f"[{name}] {t:10.3f} ms/step {c:9.1f} ops/step  {key[:110]}" for t, c, key in top]
    return rec, report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-o", "--output", type=Path, help="also write the full report here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    counters = {"frozen_tilt": ft.LAUNCHES, "tri_kernels": tk.LAUNCHES,
                "vertex_sum": vs.LAUNCHES}
    lanes = {"kozlov_L3": chip_smoke.KOZLOV_FIXTURE,
             "helfrich_cube_L5": chip_smoke.VESICLE_FIXTURE}
    device = chip_smoke.phase_device(torch)
    result, report = {"device": device}, []
    for lane, path in lanes.items():
        fixture = chip_smoke.load_fixture(path)
        result[lane] = {}
        for name in ("float32", "float64"):
            rec, lines = profile_dtype(torch, chip_smoke, counters, fixture,
                                       getattr(torch, name), lane)
            result[lane][name] = rec
            report += lines
            print(lines[0], flush=True)
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text("\n".join(report) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
