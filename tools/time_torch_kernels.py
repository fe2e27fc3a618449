#!/usr/bin/env python3
"""Device and host time of every hand kernel of the PyTorch port, and of its callers, on one GPU.

A command line over ``chip_smoke.py``'s timing rows, which that script's
phase 3 times at the kozlov L3 lane's shapes in float32 only.  This tool
times them on both lanes (kozlov L3: 10,817 vertices, 21,504 triangles;
helfrich_cube L5: 24,576 triangles), the per-triangle kernels at float32
and float64, the frozen-tilt rows at kozlov L3 float32.  Per row
(``chip_smoke.measure``):

- device ms per call: the device time of the operations one call issues,
  summed by ``torch.profiler`` over 200 back-to-back calls
  (``device_ms``, with the operations by name), and CUDA events around
  another 200 (``event_ms``); inputs are prepared outside the window;
- host µs per call: ``time.perf_counter`` around the event loop, no sync;
- the bound: the bytes the function must move (each of its inputs read
  once, each output written once) over 3.35 TB/s, or its operations over
  the card's peak rate for their type, whichever is larger;
- for the callers (a relax energy evaluation, an ``eval_grads``-style
  energy and vertex gradient, ``curvature_data`` forward, forward plus
  backward) also the median µs of one call followed by a device sync.

Prints one JSON line per lane and dtype and, last, one JSON object with
every row; ``-o FILE`` also writes that object there.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 tools/time_torch_kernels.py [-o FILE] [--lane LANE ...] [--dtype DTYPE ...]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
LANES = ("kozlov_L3", "helfrich_cube_L5")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-o", "--output", type=Path, help="also write the JSON object here")
    ap.add_argument("--lane", action="append", choices=LANES,
                    help="time only this lane (repeatable; default: both)")
    ap.add_argument("--dtype", action="append", choices=("float32", "float64"),
                    help="time only this dtype (repeatable; default: both)")
    args = ap.parse_args()
    lanes = args.lane or list(LANES)
    dtypes = args.dtype or ["float32", "float64"]

    import torch

    if not torch.cuda.is_available():
        print("time_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from membrane_solver_tpu_torch.kernels import _build
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    device = cs.phase_device(torch)
    _build.build(ft.KERNEL, tk.KERNEL, vs.KERNEL)
    result = {"device": device, "smi": cs.smi_line(), "rows": []}

    fixtures = {"kozlov_L3": cs.KOZLOV_FIXTURE, "helfrich_cube_L5": cs.VESICLE_FIXTURE}
    for lane in lanes:
        prob = cs.build_lane(torch, cs.load_fixture(fixtures[lane])["protocol"],
                             torch.float64).problem()
        batches = []
        if lane == "kozlov_L3" and "float32" in dtypes:
            batches.append(("float32", cs.frozen_tilt_rows(torch, ft, prob.topo, prob.n_vertices)))
        for name in dtypes:
            batches.append((name, cs.tri_rows_of(torch, tk, prob.topo,
                                                 prob.state.positions.detach(),
                                                 getattr(torch, name))))
        for name, rows in batches:
            recs = cs.measure(torch, rows, lane, name)
            result["rows"] += recs
            print(json.dumps({"lane": lane, "dtype": name, "rows": recs}), flush=True)
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
