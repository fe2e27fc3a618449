#!/usr/bin/env python3
"""Device and host time of kernel 1's member launch (``frozen_tilt_members``) at kozlov L3, one GPU.

Rows, float32, on the kozlov L3 lane's 21,504 triangles over 10,817
vertices, with seeded tilts, P1 gradients, payload and moduli
(``chip_smoke._ft_inputs``; member m's tilts the seeded ones plus 0.01 m):

- ``single energy`` and ``single gradient``: the single call ``launch``;
- ``shared energy``: B tilt pairs with g and the payload shared (the
  relax's backtrack candidates under ``torch.func.vmap``), B = 11, 9 and 3;
- ``per-member energy``: g and the payload one per member (the member
  relax's backtrack rounds), B = 9 and 3;
- ``per-member gradient``: the same with both vertex gradients (the member
  relax's iterations), B = 9 and 3.

Per row, through the wrapper ``launch_members``: ``chip_smoke.time_call``'s
profiler device ms of one call, CUDA-event ms and host µs over 200 calls,
each kernel's share of the device ms (``kernels_ms``: the triangle pass and,
with the gradient, the vertex sum), and the bound, the bytes the function
moves (each input read once, each output written once; the gradient rows
count the corner CSR, the vertex sum's input) over 3.35 TB/s.  With
``--groups``, every shared-input row also at each group size the library
takes (the C entry's ``group``: members a block; per-member inputs take
one), called through ctypes, each group's outputs checked to be the
wrapper's bits.

``--root TREE`` imports and builds that tree's package, with this tree's
timing code: run the tool once per tree in one call (parent, change,
change, parent) to compare two trees.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 tools/time_frozen_tilt_members.py [--root TREE] [--groups] [-o FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# (row, members, g and payload shared, with the gradient)
ROWS = (("single energy", 1, True, False), ("single gradient", 1, True, True),
        ("shared energy", 11, True, False), ("shared energy", 9, True, False),
        ("shared energy", 3, True, False),
        ("per-member energy", 9, False, False), ("per-member energy", 3, False, False),
        ("per-member gradient", 9, False, True), ("per-member gradient", 3, False, True))


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


def raw_call(torch, ft, t_in, t_out, rows, csr, g, pay, k, ws, grad: bool, group: int):
    """``launch_members``' call with the block's member group given: (energies, gin, gout)."""
    from membrane_solver_tpu_torch.kernels import _launch

    lib = ft.build()
    B, N = t_in.shape[0], t_in.shape[1]
    partials, counter, corners = ws.member_scratch(B, grad)
    energy = torch.empty(B, dtype=torch.float32, device=t_in.device)
    gin = torch.empty_like(t_in) if grad else None
    gout = torch.empty_like(t_out) if grad else None
    code = _launch.call(
        t_in, lib.frozen_tilt_members,
        t_in.data_ptr(), t_out.data_ptr(), rows.data_ptr(), *ft._tile_pointers(csr, grad),
        g.data_ptr(), pay.data_ptr(), k.data_ptr(), corners.data_ptr() if grad else None,
        partials.data_ptr(), counter.data_ptr(), energy.data_ptr(),
        gin.data_ptr() if grad else None, gout.data_ptr() if grad else None,
        rows.shape[0], N, B, group, 0 if g.dim() == 3 else g.stride(0),
        0 if pay.dim() == 2 else pay.stride(0), int(grad))
    if code != 0:
        raise RuntimeError(f"frozen_tilt_members at group {group}: cudaError {code}")
    return energy, gin, gout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the tree whose package is imported and built (default: this one)")
    ap.add_argument("--groups", action="store_true",
                    help="also time every group size the library takes (shared inputs)")
    ap.add_argument("-o", "--output", type=Path, help="also write the JSON object here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_frozen_tilt_members: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    sys.path.insert(0, str(args.root.resolve()))
    for name in [m for m in sys.modules if m.startswith("membrane_solver_tpu_torch")]:
        del sys.modules[name]
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    device = cs.phase_device(torch)
    ft.build()
    mn = cs.build_lane(torch, cs.load_fixture(cs.KOZLOV_FIXTURE)["protocol"], torch.float64)
    topo = mn.problem().topo
    rows, csr = topo.tri_rows, topo.corner_csr()
    T, N = rows.shape[0], mn.problem().n_vertices
    t_in, t_out, g1, pay1, k = cs._ft_inputs(torch, rows, N, 13)
    ws = ft.Workspace(T, rows.device)
    result = {"device": device, "smi": cs.smi_line(), "root": str(args.root),
              "library": ft.KERNEL.library_path().name, "rows": []}
    max_group = ft.build().frozen_tilt_max_group() if args.groups else 0
    for label, B, shared, grad in ROWS:
        a = torch.stack([t_in + 0.01 * m for m in range(B)]).contiguous()
        b = torch.stack([t_out - 0.01 * m for m in range(B)]).contiguous()
        g = g1 if shared else torch.stack([g1 * (1 + 0.01 * m) for m in range(B)]).contiguous()
        pay = pay1 if shared else torch.stack([pay1 * (1 + 0.01 * m)
                                               for m in range(B)]).contiguous()

        def call(a=a, b=b, g=g, pay=pay, grad=grad, single=label.startswith("single")):
            if single:
                return ft.launch(a[0], b[0], rows, csr, g, pay, k, ws, grad=grad)
            return ft.launch_members(a, b, rows, csr, g, pay, k, ws, grad=grad)

        outs = [o for o in call() if o is not None]
        inputs = [a, b, rows, g, pay, k] + ([csr.offsets, csr.slots] if grad else [])
        moved = cs._nbytes(inputs) + cs._nbytes(outs)
        flops = (cs.FLOPS_PER_TRI["frozen_tilt_energy"]
                 + (cs.FLOPS_PER_TRI["frozen_tilt_grad"] if grad else 0)) * T * B
        bound, bound_by = cs.bound_ms(moved, flops, "float32")
        timing = cs.time_call(torch, call)
        group = ft.group_size(B, shared) if hasattr(ft, "group_size") else 1
        rec = {"row": label, "members": B, "group": group,
               **{key: timing[key] for key in ("device_ms", "event_ms", "host_us")},
               "kernels_ms": kernel_split(torch, call), "bytes": moved, "bound_ms": bound,
               "bound_by": bound_by}
        print(json.dumps(rec), flush=True)
        result["rows"].append(rec)
        for group in range(1, max_group + 1) if B > 1 and shared else ():
            def raw(group=group, a=a, b=b, g=g, pay=pay, grad=grad):
                return raw_call(torch, ft, a, b, rows, csr, g, pay, k, ws, grad, group)

            got = [o for o in raw() if o is not None]
            want = [o for o in call() if o is not None]
            torch.cuda.synchronize()
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(got, want))
            timing = cs.time_call(torch, raw)
            rec = {"row": label, "members": B, "group": group, "same_bits": same,
                   **{key: timing[key] for key in ("device_ms", "event_ms", "host_us")},
                   "kernels_ms": kernel_split(torch, raw), "bound_ms": bound}
            print(json.dumps(rec), flush=True)
            result["rows"].append(rec)
            if not same:
                raise AssertionError(f"{label} B={B}: group {group} is not the wrapper's bits")
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
