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

At kozlov L3 float32 it also times ``vertex_sum.row_sum``'s launch over
each slot CSR a kozlov step keeps (``state.kept_slot_csr``: the pins'
shared normals, the KKT rows; skewed, up to 18 slots in a row, most of
them in the spare row that ``row_sum`` drops and, through
``vertex_sum.summed_rows``, does not sum; a tree without it sums that row
too), seeded values, beside ``index_add_`` of the same values.  With
``--members B`` (repeatable) it also times the member-axis rows of phase
34 (``chip_smoke.member_rows``: every member entry, its twin, and
``index_add_`` over the members' rows; kernel 2's energy also at the
kozlov single problem's Armijo tail of 9 members; a hand kernel's row split
by launch in ``kernels_ms``) at kozlov L3 at each dtype, B
members of the lane's positions scaled by 1 + 0.001 m and seeded tilts,
and at float32 kernel 1's member rows (``chip_smoke.ft_member_rows``: g
and the payload shared at B = 11, one per member at B = 9, the energy
alone and with the gradient).

Prints one JSON line per lane and dtype and, last, one JSON object with
every row; ``-o FILE`` also writes that object there.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 tools/time_torch_kernels.py [-o FILE] [--lane LANE ...] [--dtype DTYPE ...]
        [--members B ...]

The tool reads only the ``chip_smoke.py`` and the package beside it, so a
copy of it in an unpacked older tree times that tree.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# the slot CSRs a kozlov step keeps (state.kept_slot_csr keys)
SLOT_CSRS = ("constraint:pin_to_circle/normals", "constraint:pin_to_plane/normals",
             "kkt/compact_rows")
LANES = ("kozlov_L3", "helfrich_cube_L5")


def slot_csr_rows(torch, cs, vs, topo) -> list:
    """(name, kind, fn, inputs, flops): ``row_sum``'s launch over each slot CSR ``topo`` keeps.

    Float32 seeded values, (K / 3, 3, 3) for the K padded slots, and
    ``index_add_`` of the same values into the CSR's rows.
    """
    gen = torch.Generator(device=cs.DEVICE).manual_seed(23)
    summed = getattr(vs, "summed_rows", lambda c: c)  # the CSR row_sum launches over
    rows = []
    for key in SLOT_CSRS:
        def absent(key=key):
            raise KeyError(f"the kozlov step kept no slot CSR {key!r}")

        csr = topo.kept(("slot_csr", key), absent)
        vals = torch.randn((csr.slots.shape[0] // 3, 3, 3), dtype=torch.float32,
                           device=cs.DEVICE, generator=gen)
        target = csr.rows.reshape(-1).long()
        out = torch.zeros((csr.n_rows, 3), dtype=torch.float32, device=cs.DEVICE)
        rows += [
            (f"row_sum {key}", "kernel", lambda v=vals, c=summed(csr): vs.launch(v, c),
             (vals, csr.offsets, csr.slots), vals.numel()),
            (f"row_sum {key}", "library",
             lambda v=vals, t=target, o=out: o.index_add_(0, t, v.reshape(-1, 3)),
             (vals, target), vals.numel()),
        ]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-o", "--output", type=Path, help="also write the JSON object here")
    ap.add_argument("--lane", action="append", choices=LANES,
                    help="time only this lane (repeatable; default: both)")
    ap.add_argument("--dtype", action="append", choices=("float32", "float64"),
                    help="time only this dtype (repeatable; default: both)")
    ap.add_argument("--members", type=int, action="append", default=[],
                    help="also time the member-axis rows at kozlov L3 with B members "
                         "(repeatable)")
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
        mn = cs.build_lane(torch, cs.load_fixture(fixtures[lane])["protocol"], torch.float64)
        prob = mn.problem()
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
        for B in args.members if lane == "kozlov_L3" else ():
            for name in dtypes:
                dtype = getattr(torch, name)
                pos = prob.state.positions.detach().to(dtype)
                pos = torch.stack([pos * (1 + 0.001 * m) for m in range(B)]).contiguous()
                gen = torch.Generator(device=cs.DEVICE).manual_seed(29)
                tilts = 0.3 * torch.randn(tuple(pos.shape), dtype=dtype, device=cs.DEVICE,
                                          generator=gen)
                rows = cs.member_rows(torch, tk, vs, prob.topo, pos, tilts,
                                      ft if name == "float32" else None)
                recs = list(cs.measure_members(torch, rows, name).values())
                for r in recs:
                    r.update(lane=lane, members=B)
                result["rows"] += recs
                print(json.dumps({"lane": lane, "dtype": name, "members": B, "rows": recs}),
                      flush=True)
        if lane == "kozlov_L3" and "float32" in dtypes:
            mn.minimize(1)  # builds the step's slot CSRs
            recs = cs.measure(torch, slot_csr_rows(torch, cs, vs, mn.problem().topo), lane,
                              "float32")
            result["rows"] += recs
            print(json.dumps({"lane": lane, "dtype": "float32", "rows": recs}), flush=True)
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
