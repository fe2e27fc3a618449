#!/usr/bin/env python3
"""Device and host time of kernel 2's member launch (``tri_surface_energy_members``) at kozlov L3, one GPU.

Rows, at float32 and float64, on the kozlov L3 lane's 21,504 triangles over
10,817 vertices, member m's positions the lane's scaled by 1 + 0.001 m, its
own tension (shared by the members) and mask:

- ``single energy`` and ``single gradient``: the single call
  ``launch_surface_energy``;
- ``member energy``: B members, the energy alone: B = 8 (the kozlov sweep's
  members), 9 (the kozlov single problem's batched Armijo tail: candidates
  1-9), 72 (the sweep's batched member search tail, 8 x 9 rows) and 4;
- ``member gradient``: the same with the vertex gradient, B = 8, 9 and 4;
- ``area route``: the area constraints' call under ``vmap``, the gradient at
  unit tension, B = 4, on the kozlov lane and on the square_to_circle lane's
  mesh (meshgen ``square_to_circle`` at n = 56: 3,249 vertices, 6,272
  triangles, phase 38's sizes), whose tiles hold few whole vertex fans.

Per row, through the wrapper ``launch_surface_energy_members``:
``chip_smoke.time_call``'s profiler device ms of one call, CUDA-event ms and
host µs over 200 calls, each kernel's share of the device ms
(``kernels_ms``: the triangle pass and, with the gradient, the vertex sum),
and the bound, the bytes the function moves (each input read once, each
output written once; the gradient rows count the corner CSR, the vertex
sum's input) over 3.35 TB/s.  With ``--groups``, every member row also at
each group the library takes (members a block), each group's outputs
checked to be the default's bits.

``--root TREE`` imports and builds that tree's package, with this tree's
timing code: run the tool once per tree in one call (parent, change,
change, parent) to compare two trees.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 tools/time_surface_members.py [--root TREE] [--groups] [--dtype DTYPE ...] [-o FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# (row, members, with the gradient, unit tension)
ROWS = (("single energy", 1, False, False), ("single gradient", 1, True, False),
        ("member energy", 8, False, False), ("member energy", 9, False, False),
        ("member energy", 72, False, False), ("member energy", 4, False, False),
        ("member gradient", 8, True, False), ("member gradient", 9, True, False),
        ("member gradient", 4, True, False), ("area route", 4, True, True),
        ("square area route", 4, True, True))


def kernel_split(torch, fn, calls: int = 200) -> dict:
    """Profiler device ms per call of ``fn`` by kernel name (the first 40 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = e.key[:40]
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the tree whose package is imported and built (default: this one)")
    ap.add_argument("--groups", action="store_true",
                    help="also time every group the library takes")
    ap.add_argument("--dtype", action="append", choices=("float32", "float64"),
                    help="time only this dtype (repeatable; default: both)")
    ap.add_argument("-o", "--output", type=Path, help="also write the JSON object here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_surface_members: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    sys.path.insert(0, str(args.root.resolve()))
    for name in [m for m in sys.modules if m.startswith("membrane_solver_tpu_torch")]:
        del sys.modules[name]
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    device = cs.phase_device(torch)
    lib = tk.build()
    max_group = lib.tri_surface_max_group() if args.groups else 0
    from membrane_solver_tpu_torch import Minimizer, parse_geometry
    from membrane_solver_tpu_torch.meshgen import build

    lanes = {"kozlov": cs.build_lane(torch, cs.load_fixture(cs.KOZLOV_FIXTURE)["protocol"],
                                     torch.float64).problem(),
             "square": Minimizer(parse_geometry(build("square_to_circle", n=56)), device=cs.DEVICE,
                                 dtype=torch.float64, quiet=True).problem()}
    result = {"device": device, "smi": cs.smi_line(), "root": str(args.root),
              "library": tk.KERNEL.library_path().name, "rows": []}
    F = cs.FLOPS_PER_TRI
    for name in args.dtype or ["float32", "float64"]:
        dtype = getattr(torch, name)
        for label, B, grad, unit in ROWS:
            prob = lanes["square" if label.startswith("square") else "kozlov"]
            topo = prob.topo
            rows, valid, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
            T = rows.shape[0]
            base = prob.state.positions.detach().to(dtype)
            tension = topo.tri_surface_tension.to(dtype)
            pos = torch.stack([base * (1 + 0.001 * m) for m in range(B)]).contiguous()
            gamma = torch.ones_like(tension) if unit else tension
            ws = tk.MemberWorkspace(B, T, dtype, cs.DEVICE)
            one_ws = tk.Workspace(T, dtype, cs.DEVICE)

            def call(pos=pos, gamma=gamma, ws=ws, grad=grad, single=label.startswith("single")):
                if single:
                    return tk.launch_surface_energy(pos[0], rows, valid, gamma, csr, one_ws, grad)
                return tk.launch_surface_energy_members(pos, rows, valid, gamma, csr, ws, grad)

            outs = [o for o in call() if o is not None]
            inputs = [pos, rows, valid, gamma] + ([csr.offsets, csr.slots] if grad else [])
            moved = cs._nbytes(inputs) + cs._nbytes(outs)
            flops = (F["surface_energy"] + (F["surface_grad"] if grad else 0)) * T * B
            bound, bound_by = cs.bound_ms(moved, flops, name)
            timing = cs.time_call(torch, call)
            group = tk.group_size(B) if hasattr(tk, "group_size") and B > 1 else 1
            rec = {"row": label, "dtype": name, "members": B, "group": group,
                   **{key: timing[key] for key in ("device_ms", "event_ms", "host_us")},
                   "kernels_ms": kernel_split(torch, call), "bytes": moved, "bound_ms": bound,
                   "bound_by": bound_by}
            print(json.dumps(rec), flush=True)
            result["rows"].append(rec)
            for g in range(1, max_group + 1) if B > 1 else ():
                def raw(g=g, pos=pos, gamma=gamma, ws=ws, grad=grad):
                    return tk.launch_surface_energy_members(pos, rows, valid, gamma, csr, ws,
                                                            grad, group=g)

                got = [o for o in raw() if o is not None]
                want = [o for o in call() if o is not None]
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, want))
                timing = cs.time_call(torch, raw)
                rec = {"row": label, "dtype": name, "members": B, "group": g, "same_bits": same,
                       **{key: timing[key] for key in ("device_ms", "event_ms", "host_us")},
                       "kernels_ms": kernel_split(torch, raw), "bound_ms": bound}
                print(json.dumps(rec), flush=True)
                result["rows"].append(rec)
                if not same:
                    raise AssertionError(f"{label} B={B} {name}: group {g} is not the default's "
                                         "bits")
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
