#!/usr/bin/env python3
"""Device and host time of kernel 4 (the P1 divergence) and its tilt backward at kozlov L3, one GPU.

Rows, at float32 and float64, on the kozlov L3 lane's 21,504 triangles over
10,817 vertices: member m's positions the lane's scaled by 1 + 0.001 m,
its tilts seeded ones scaled by 1 - 0.01 m, the lane's mask.

- ``single`` (``launch_p1_divergence``), with the shape gradients g and
  without (``grads`` False: the energy's and the face values' call);
- ``member`` (``launch_p1_divergence_members``), every input per member,
  with and without g: B = 4, 8 (the kozlov sweep's members), 9 and 72 (the
  sweep's batched member search tail, 8 x 9 rows);
- ``positions shared`` at B = 8 and 72, with and without g (g and the area
  then one member's), and ``tilts shared`` at B = 8 with g;
- ``tilt backward`` (``launch_p1_div_bwd``) and ``member tilt backward``
  (``launch_p1_div_bwd_members``) at B = 8 and 72, and at B = 8 on one g
  shared by the members; beside them ``vertex sum``, the plain sum of the
  same g over the same corner CSR (``vertex_sum.launch``, members: its
  member launch), what the weighted form adds to.

Per row: ``chip_smoke.time_call``'s profiler device ms of one call,
CUDA-event ms and host µs over 200 calls, each kernel's share of the device
ms (``kernels_ms``), and the bound: the bytes the job moves (each input read
once, a shared one once; each output written once, g only where the row
writes it; the backward's corner CSR) over 3.35 TB/s.

``--root TREE`` imports and builds that tree's package, with this tree's
timing code.  A tree whose launches take no ``grads`` and no shared input
(before the member groups) does each row's job its own way: it writes g
where the row does not ask for it, and a shared input is expanded and made
contiguous first, as that tree's ``vmap`` rule did.  Run the tool once per
tree in one call (parent, change, change, parent) to compare two trees.
With ``--groups``, every member row also at each group the library takes,
each group's outputs checked to be the default's bits.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 tools/time_p1_div_members.py [--root TREE] [--groups] [--dtype DTYPE ...] [-o FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# (row, members, form, g written)
FORWARD = (("single", 1, "per member", True), ("single", 1, "per member", False),
           ("member", 4, "per member", True), ("member", 4, "per member", False),
           ("member", 8, "per member", True), ("member", 8, "per member", False),
           ("member", 9, "per member", True), ("member", 9, "per member", False),
           ("member", 72, "per member", True), ("member", 72, "per member", False),
           ("member", 8, "positions shared", True), ("member", 8, "positions shared", False),
           ("member", 72, "positions shared", True), ("member", 72, "positions shared", False),
           ("member", 8, "tilts shared", True))
# (row, members, g shared)
BACKWARD = (("tilt backward", 1, False), ("vertex sum", 1, False),
            ("member tilt backward", 8, False), ("member vertex sum", 8, False),
            ("member tilt backward", 72, False), ("member vertex sum", 72, False),
            ("member tilt backward", 8, True))


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

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_p1_div_members: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import chip_smoke as cs
    from time_surface_members import kernel_split

    sys.path.insert(0, str(args.root.resolve()))
    for name in [m for m in sys.modules if m.startswith("membrane_solver_tpu_torch")]:
        del sys.modules[name]
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    device = cs.phase_device(torch)
    lib = tk.build()
    grouped = hasattr(tk, "DIV_GROUPS")  # a tree with the member groups and the g-less form
    fwd_groups = lib.tri_p1_div_max_group() if args.groups and grouped else 0
    bwd_groups = lib.tri_p1_div_bwd_max_group() if args.groups and grouped else 0
    prob = cs.build_lane(torch, cs.load_fixture(cs.KOZLOV_FIXTURE)["protocol"],
                         torch.float64).problem()
    topo = prob.topo
    rows, valid, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
    T, nv = rows.shape[0], prob.state.positions.shape[0]
    rng = np.random.default_rng(29)
    seeded_tilts = 0.3 * rng.standard_normal((nv, 3))
    result = {"device": device, "smi": cs.smi_line(), "root": str(args.root),
              "library": tk.KERNEL.library_path().name, "grouped": grouped, "rows": []}
    F = cs.FLOPS_PER_TRI

    def record(rec, call, bound, bound_by):
        timing = cs.time_call(torch, call)
        rec.update({key: timing[key] for key in ("device_ms", "event_ms", "host_us")})
        rec.update({"kernels_ms": kernel_split(torch, call), "bound_ms": bound,
                    "bound_by": bound_by})
        print(json.dumps(rec), flush=True)
        result["rows"].append(rec)

    def same(got, want) -> bool:
        torch.cuda.synchronize()
        return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(got, want))

    for name in args.dtype or ["float32", "float64"]:
        dtype = getattr(torch, name)
        base = prob.state.positions.detach().to(dtype)
        tl = torch.as_tensor(seeded_tilts, dtype=dtype, device=cs.DEVICE)
        for label, B, form, grads in FORWARD:
            pos = torch.stack([base * (1 + 0.001 * m) for m in range(B)]).contiguous()
            tilts = torch.stack([tl * (1 - 0.01 * m) for m in range(B)]).contiguous()
            p = pos[0].contiguous() if form == "positions shared" else pos
            t = tilts[0].contiguous() if form == "tilts shared" else tilts

            def call(p=p, t=t, B=B, grads=grads, single=label == "single", group=None):
                if single:
                    if grouped:
                        return tk.launch_p1_divergence(p[0], t[0], rows, valid, grads=grads)
                    return tk.launch_p1_divergence(p[0], t[0], rows, valid)
                if grouped:
                    return tk.launch_p1_divergence_members(p, t, rows, valid, grads=grads,
                                                           group=group)
                # the parent's vmap rule: a shared input expanded to the members, then copied
                return tk.launch_p1_divergence_members(
                    p.expand(B, nv, 3).contiguous(), t.expand(B, nv, 3).contiguous(), rows,
                    valid)

            # the job's bytes: the inputs as given (a shared one once), div, the area and g
            # (one member's where the positions are shared), g only where the row writes it
            lead = 1 if label == "single" or form == "positions shared" else B
            moved = (cs._nbytes([p[0] if label == "single" else p,
                                 t[0] if label == "single" else t, rows, valid])
                     + B * T * base.element_size() + lead * T * base.element_size()
                     + (lead * 9 * T * base.element_size() if grads else 0))
            bound, bound_by = cs.bound_ms(moved, F["p1_div"] * T * B, name)
            rec = {"row": label, "dtype": name, "members": B, "form": form, "g": grads,
                   "group": (tk.div_group_size(dtype, form == "positions shared")
                             if grouped and B > 1 else 1),
                   "bytes": moved}
            record(rec, call, bound, bound_by)
            for g in range(1, fwd_groups + 1) if label != "single" else ():
                got, want = call(group=g), call()
                ok = same(got, want)
                rec = {"row": label, "dtype": name, "members": B, "form": form, "g": grads,
                       "group": g, "same_bits": ok, "bytes": moved}
                record(rec, lambda g=g, call=call: call(group=g), bound, bound_by)
                if not ok:
                    raise AssertionError(f"{label} B={B} {form} g={grads} {name}: group {g} is "
                                         "not the default's bits")
        for label, B, shared in BACKWARD:
            gs = torch.as_tensor(rng.standard_normal((B, T, 3, 3)), dtype=dtype,
                                 device=cs.DEVICE)
            g_src = gs[0].contiguous() if shared else gs
            w = torch.as_tensor(rng.standard_normal((B, T)), dtype=dtype, device=cs.DEVICE)
            mask = valid & (torch.as_tensor(rng.random(T), device=cs.DEVICE) < 0.8)

            def call(g_src=g_src, w=w, B=B, label=label, group=None):
                if label == "tilt backward":
                    return tk.launch_p1_div_bwd(g_src[0], mask, w[0], csr)
                if label == "vertex sum":
                    return vs.launch(g_src[0], csr)
                if label == "member vertex sum":
                    return vs.launch_members(g_src, csr)
                if grouped:
                    return tk.launch_p1_div_bwd_members(g_src, mask, w, csr, group=group)
                return tk.launch_p1_div_bwd_members(g_src.expand(B, T, 3, 3).contiguous(), mask,
                                                    w, csr)

            weighted = "backward" in label
            inputs = [g_src[0] if B == 1 else g_src, csr.offsets, csr.slots]
            if weighted:
                inputs += [mask, w[0] if B == 1 else w]
            moved = cs._nbytes(inputs) + B * nv * 3 * base.element_size()
            bound, bound_by = cs.bound_ms(moved, F["p1_div_bwd"] * T * B, name)
            rec = {"row": label, "dtype": name, "members": B, "g_shared": shared,
                   "group": (tk.DIV_BWD_GROUPS[(dtype, shared)] if grouped and weighted and B > 1
                             else 1),
                   "bytes": moved}
            record(rec, call, bound, bound_by)
            for g in range(1, bwd_groups + 1) if weighted and B > 1 else ():
                ok = same([call(group=g)], [call()])
                rec = {"row": label, "dtype": name, "members": B, "g_shared": shared,
                       "group": g, "same_bits": ok, "bytes": moved}
                record(rec, lambda g=g, call=call: call(group=g), bound, bound_by)
                if not ok:
                    raise AssertionError(f"{label} B={B} {name}: group {g} is not the default's "
                                         "bits")
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
