#!/usr/bin/env python3
"""Where a sweep member stops being its one-member sweep's bits.

The parameter sweep (``membrane_solver_tpu_torch/parallel``) must give
member m of a B-member sweep the bits of a one-member sweep of member m.
This runs a lane's sweep protocol at B members and each member alone,
from the state the lane's own steps leave, and compares every field and
stat bit for bit.  Lanes: the sweep fixtures' (``kozlov``, ``vesicle``,
``square``, ``rect``, ``interface``, ``free_disk``, ``physical_edge``,
``scaffold``), built as ``chip_smoke.py`` builds them.

``--trace`` also records every torch call on the member path
(``torch.overrides.TorchFunctionMode``): a fingerprint of each member's
inputs and outputs (an exact integer sum of their bits), keyed by the
call's frames inside the package and its occurrence.  A call whose
inputs are member m's bits in both runs and whose output is not is a
source: it adds in an order that depends on the member count.  Each
source is printed once, with its frames.  It holds each call's member rows
against the one-member run's: the batched line search's tail rows are
(member, candidate) pairs, so its calls take no part under that form.

``--audit`` lists, by call site, the reductions, products and solves the
member path calls on member-batched operands (inside ``torch.func.vmap``,
or the block's own (B, ...) arrays), with the extent each one reduces and
the widths of the member axes it saw (B; under the batched line search
also the tail's 9 x R rows, ``MEMBRANE_SOLVER_BATCHED_LS=1`` on the CPU).

Usage::

    python3 tools/member_bits.py --lane kozlov --dtype float64 [--trace] [--audit]
    python3 tools/member_bits.py --cpu --small --lane kozlov vesicle --audit

``--small`` cuts each lane to one refinement (rect and square to their
smallest meshes) for the CPU.  ``--time N`` instead times the lane's sweep
at B members: a warm-up step, then N repeats of three steps, each
between two device syncs on the host clock; it prints ms per sweep step
and the card's name and power limit.  Exit code 1 when a member differs.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
PKG = str(REPO / "membrane_solver_tpu_torch")
STATE_FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")
STATS = ("energy", "accepted_energy", "grad_norm", "step_size", "step_success", "converged",
         "terminated_early", "zero_step_counter", "iterations", "trials", "accepted_steps",
         "trace_z_fallbacks")
LANES = {
    "kozlov": "kozlov_L3_sweep_f64_jax.json",
    "vesicle": "helfrich_cube_L5_sweep_f64_jax.json",
    "square": "square_to_circle_L1_sweep_f64_jax.json",
    "rect": "rect_tilt_source_L0_sweep_f64_jax.json",
    "interface": "kozlov_L3_interface_sweep_f64_jax.json",
    "free_disk": "kozlov_L3_free_disk_sweep_f64_jax.json",
    "physical_edge": "kozlov_L3_physical_edge_sweep_f64_jax.json",
    "scaffold": "kozlov_L3_scaffold_sweep_f64_jax.json",
}
# calls whose result depends on the order they add in (exact ones, max, any, sort, are left out)
ORDERED = {"sum", "mean", "nansum", "prod", "norm", "vector_norm", "matrix_norm", "dist", "std",
           "var", "cumsum", "cumprod", "logsumexp", "matmul", "__matmul__", "__rmatmul__", "mm",
           "bmm", "mv", "dot", "vdot", "inner", "einsum", "tensordot", "addmm", "baddbmm",
           "solve", "solve_ex", "lu_factor", "lu_factor_ex", "lu_solve", "inv", "inv_ex",
           "cholesky", "cholesky_ex", "eigh", "svd", "svdvals", "qr", "lstsq", "det", "slogdet",
           "index_add", "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
           "index_put", "index_put_", "bincount", "cdist", "trapezoid"}


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def _site(depth: int = 3) -> tuple:
    """The caller's frames inside the package, innermost first, as ``path:line``."""
    out = []
    f = sys._getframe(depth)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(PKG):
            out.append(f"{os.path.relpath(name, REPO)}:{f.f_lineno}")
        f = f.f_back
    return tuple(out)


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _member_rows(t, B: int, top: bool):
    """(B, ...) member rows of ``t``: batched at the (one) vmap level, or with ``top`` a
    (B, ...) array of the block's own; None for a tensor every member shares."""
    from torch._C import _functorch as ft

    if ft.is_batchedtensor(t):
        u = ft.get_unwrapped(t)
        if ft.is_batchedtensor(u):
            return "nested"
        return u.movedim(ft.maybe_get_bdim(t), 0)
    if top and t.dim() >= 1 and t.shape[0] == B:
        return t
    return None


def _fingerprint(x):
    """(rows,) int64: an exact, position-weighted integer sum of each row's bits."""
    import torch

    x = x.detach()
    if x.is_complex():
        x = torch.view_as_real(x)
    rows = x.shape[0] if x.dim() else 1
    x = x.contiguous().reshape(rows, -1)
    if x.dtype == torch.float64:
        b = x.view(torch.int64)
    elif x.dtype == torch.float32:
        b = x.view(torch.int32).to(torch.int64)
    elif x.is_floating_point():
        b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    else:
        b = x.to(torch.int64)
    w = torch.arange(b.shape[1], device=b.device, dtype=torch.int64) % 1021 + 1
    return (b * w).sum(dim=1)


class Recorder:
    """The calls one run makes on the member path: fingerprints (``--trace``) and the ordered
    reductions on member-batched operands (``--audit``)."""

    def __init__(self, B: int, trace: bool, audit: bool):
        from torch.overrides import TorchFunctionMode

        rec = self
        self.B, self.trace, self.audit = B, trace, audit
        self.keys, self.parts, self.fps = [], [], []
        self.occurrence = collections.Counter()
        self.ordered = collections.Counter()
        self.widths = collections.defaultdict(set)

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                outs = list(_tensors(out))
                if outs:
                    rec.note(func, args, kwargs, outs)
                return out

        self.mode = Mode()

    def fp(self, t, top: bool):
        rows = _member_rows(t, self.B, top)
        if isinstance(rows, str):
            return None
        if rows is None:
            self.fps.append(_fingerprint(t.reshape(1, -1) if t.dim() else t.reshape(1)))
            return ("shared", len(self.fps) - 1)
        self.fps.append(_fingerprint(rows))
        return ("member", len(self.fps) - 1)

    def note(self, func, args, kwargs, outs) -> None:
        site = _site()
        if not site:
            return
        name = getattr(func, "__name__", repr(func)).removeprefix("linalg_")
        top = site[0].startswith("membrane_solver_tpu_torch/parallel/member_block.py")
        ins = list(_tensors((args, kwargs)))
        batched = [t for t in ins if _member_rows(t, self.B, top) is not None]
        if not batched and not any(_member_rows(t, self.B, top) is not None for t in outs):
            return
        if name in ("index_put", "index_put_") and not kwargs.get(
                "accumulate", len(args) > 3 and bool(args[3])):
            name += "(overwrite)"
        if self.audit and name in ORDERED:
            key = (site[0], name, _extent(name, args, kwargs))
            self.ordered[key] += 1
            rows = (_member_rows(t, self.B, top) for t in batched)
            self.widths[key].update(int(r.shape[0]) for r in rows if not isinstance(r, str))
        if self.trace:
            key = (site, name)
            self.occurrence[key] += 1
            self.keys.append((site, name, self.occurrence[key]))
            self.parts.append(([self.fp(t, top) for t in ins], [self.fp(t, top) for t in outs]))

    def finish(self) -> dict:
        """{(site, name, occurrence): (inputs, outputs)}, each a list of ("member", (B,) array)
        or ("shared", (1,) array)."""
        import torch

        flat = (torch.cat([f.reshape(-1).cpu() for f in self.fps]).numpy() if self.fps
                else None)
        sizes = [int(f.numel()) for f in self.fps]
        starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

        def get(ref):
            if ref is None:
                return None
            kind, i = ref
            return kind, flat[starts[i]:starts[i + 1]]

        return {k: ([get(r) for r in ins], [get(r) for r in outs])
                for k, (ins, outs) in zip(self.keys, self.parts)}


def _extent(name: str, args, kwargs) -> str:
    """What one call of ``name`` reduces, from its logical shapes."""
    import torch

    ts = list(_tensors(args))
    if not ts:
        return "?"
    a = ts[0]
    shape = tuple(a.shape)
    if name in ("matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "mv", "dot", "vdot", "inner",
                "addmm", "baddbmm", "tensordot"):
        return f"{shape} x {tuple(ts[1].shape) if len(ts) > 1 else '?'}"
    if name == "einsum":
        spec = args[0] if args and isinstance(args[0], str) else "?"
        return f"{spec} {[tuple(t.shape) for t in ts]}"
    dim = kwargs.get("dim", args[1] if len(args) > 1 and isinstance(args[1], (int, tuple, list))
                     else None)
    if dim is None:
        return f"all of {shape}"
    if not isinstance(dim, (int, tuple, list)):
        return f"{shape}"
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    n = 1
    for d in dims:
        n *= shape[d] if shape else 1
    return f"{n} of {shape} over {dims}" if isinstance(a, torch.Tensor) else "?"


def lane_problem(cs, torch, lane: str, dtype, small: bool):
    """(compiled problem, sweep protocol) of ``lane`` after its own steps."""
    fixture = json.loads((cs.FIXTURES / LANES[lane]).read_text())
    proto = copy.deepcopy(fixture["protocol"])
    if lane in ("square", "rect"):
        from membrane_solver_tpu_torch.commands import execute_command_line

        sub = proto["square_to_circle" if lane == "square" else "rect_tilt_source"]
        if small and lane == "rect":
            sub["meshgen"]["args"].update(nx=20, ny=8)
        if cs.DEVICE == "cpu":
            sub["cli_args"] = list(sub["cli_args"]) + ["--cpu"]
        commands = sub["commands"]
        if small and lane == "square":
            commands = [c for c in commands if c.strip() != "r"]
        ctx = cs.cli_context(torch, sub, dtype)
        for cmd in commands:
            execute_command_line(ctx, cmd)
            ctx.sync_mesh()
        return ctx.minimizer.problem(), proto
    if lane == "vesicle":
        sub = dict(proto["vesicle"])
        sub["global_parameters"] = {**sub["global_parameters"], **proto["global_parameters"]}
    else:
        sub = proto["kozlov"]
    if small:
        sub = {**sub, "refines": 1}
    mn = cs.build_lane(torch, sub, dtype)
    for _ in range(sub["steps"]):
        mn.minimize(1)
    cs.uneven_disk(mn, proto)
    return mn.problem(), proto


def run(cs, torch, problem, proto, members, recorder=None):
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    params, positions = cs.sweep_members(proto, problem.state.positions.detach().cpu().numpy(),
                                         problem.params)
    kw = dict(step_size=proto["step_size"], options=MinimizeOptions(**cs.sweep_options(proto)),
              member_positions=[positions[m] for m in members])
    steps = 1 if recorder is not None and recorder.trace else proto["steps"]
    if recorder is None:
        return run_sweep(problem, [params[m] for m in members], steps, **kw)
    with recorder.mode:
        return run_sweep(problem, [params[m] for m in members], steps, **kw)


def differing_fields(got, m: int, one) -> list:
    """The fields and stats in which member ``m`` of ``got`` is not ``one``'s member 0's bits."""
    out = []
    for f in STATE_FIELDS:
        a, b = getattr(got[0], f)[m].detach().cpu(), getattr(one[0], f)[0].detach().cpu()
        if a.numpy().tobytes() != b.numpy().tobytes():
            out.append(f)
    for k in STATS:
        a, b = np.asarray(getattr(got[2], k))[m], np.asarray(getattr(one[2], k))[0]
        if np.asarray(a).tobytes() != np.asarray(b).tobytes():
            out.append(k)
    return out


def sources(batch: dict, single: dict, m: int) -> list:
    """The calls whose inputs are member ``m``'s bits in both runs and whose output is not."""

    def pick(entry, row):
        if entry is None:
            return None
        kind, vals = entry
        return ("shared", tuple(vals)) if kind == "shared" else ("member", int(vals[row]))

    found = []
    for key, (s_in, s_out) in single.items():
        if key not in batch:
            continue
        b_in, b_out = batch[key]
        if [pick(e, 0) for e in s_in] != [pick(e, m) for e in b_in]:
            continue
        # a value of all members together (the block's summed energies) is no member's
        if [pick(e, 0) for e in s_out if e and e[0] == "member"] != \
                [pick(e, m) for e in b_out if e and e[0] == "member"]:
            found.append(key)
    return found


def timing(cs, torch, problem, proto, B: int, repeats: int, lane: str, name: str) -> None:
    """ms per sweep step at B members: a warm-up step, then ``repeats`` runs of three."""
    steps = 3
    warm = dict(proto, steps=1)
    run(cs, torch, problem, warm, range(B))
    per = []
    for _ in range(repeats):
        sync = torch.cuda.synchronize if cs.DEVICE == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        run(cs, torch, problem, dict(proto, steps=steps), range(B))
        sync()
        per.append((time.perf_counter() - t0) * 1e3 / steps)
    print(json.dumps({"lane": lane, "dtype": name, "members": B, "vertices": problem.n_vertices,
                      "ms_per_sweep_step": per, "median": float(np.median(per)),
                      "card": cs.smi_line() if cs.DEVICE == "cuda" else "cpu"}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lane", nargs="+", default=list(LANES), choices=list(LANES))
    ap.add_argument("--dtype", nargs="+", default=["float64", "float32"])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--audit", action="store_true")
    ap.add_argument("--trace-members", type=int, nargs="+", default=None,
                    help="the members traced (default: all)")
    ap.add_argument("--time", type=int, default=0, metavar="N")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    import torch

    cs = _chip_smoke()
    cs.DEVICE = "cpu" if args.cpu else "cuda"
    if not args.cpu and not torch.cuda.is_available():
        print("member_bits: no CUDA device (pass --cpu)", file=sys.stderr)
        return 2
    if cs.DEVICE == "cuda":
        from membrane_solver_tpu_torch.kernels import _build

        _build.build(*(m.KERNEL for m in cs.kernel_modules()))  # one nvcc per source
    failed = False
    audit = collections.Counter()
    widths = collections.defaultdict(set)
    for lane in args.lane:
        for name in args.dtype:
            dtype = getattr(torch, name)
            t0 = time.perf_counter()
            problem, proto = lane_problem(cs, torch, lane, dtype, args.small)
            B = proto["members"]
            setup = time.perf_counter() - t0
            if args.time:
                timing(cs, torch, problem, proto, B, args.time, lane, name)
                continue
            rec = Recorder(B, False, args.audit) if args.audit else None
            got = run(cs, torch, problem, proto, range(B), rec)
            if rec is not None:
                audit.update(rec.ordered)
                for key, seen in rec.widths.items():
                    widths[key] |= seen
            diffs = {}
            for m in range(B):
                one = run(cs, torch, problem, proto, [m])
                d = differing_fields(got, m, one)
                if d:
                    diffs[m] = d
            failed |= bool(diffs)
            print(json.dumps({"lane": lane, "dtype": name, "members": B,
                              "vertices": problem.n_vertices, "setup_s": round(setup, 3),
                              "seconds": round(time.perf_counter() - t0 - setup, 3),
                              "differing": diffs}), flush=True)
            if args.trace:
                rb = Recorder(B, True, False)
                run(cs, torch, problem, proto, range(B), rb)
                batch = rb.finish()
                seen = {}
                for m in args.trace_members or range(B):
                    r1 = Recorder(1, True, False)
                    run(cs, torch, problem, proto, [m], r1)
                    for site, fname, occ in sources(batch, r1.finish(), m):
                        seen.setdefault((site[0], fname), (site, occ, []))[2].append(m)
                for (top, fname), (site, occ, ms) in seen.items():
                    print(json.dumps({"lane": lane, "dtype": name, "source": top, "call": fname,
                                      "first_occurrence": occ, "members": ms,
                                      "frames": list(site[:6])}), flush=True)
    if args.audit:
        for (site, fname, extent), n in sorted(audit.items()):
            print(json.dumps({"audit": site, "call": fname, "extent": extent, "calls": n,
                              "widths": sorted(widths[(site, fname, extent)])}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
