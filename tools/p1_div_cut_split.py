#!/usr/bin/env python3
"""Where kernel 4's time goes: its tilt backward and its forward's gathers, in library variants.

Builds ``csrc/tri_kernels.cu`` of a tree (``--root``, default this one; with
the shared headers) once as it is and once per variant, each into its own
directory under ``--build`` (one ``nvcc`` each, all started together), and
times each library's ``tri_p1_div_bwd`` (single) and
``tri_p1_div_bwd_members`` (B = 8) at the kozlov L3 lane's corner CSR,
width 3, beside the plain vertex sum of the same values over the same CSR
(``vertex_sum.launch`` and its member launch, from the vertex-sum library,
which no variant touches).  Each variant is a text replacement; a variant
whose text is not in the tree's source is left out of that tree's run (the
tree's layout does not have it).  The backward's variants, in the weighted
form's per-slot code:

- ``no_mask_weight``: weight 1 and no mask (no per-triangle load);
- ``mask_only``: the mask read, no weight (w = 1 where it is set);
- ``weight_only``: the weight read, no mask: the cost of one per-triangle
  load a slot, as if a per-triangle pass had folded the mask into the
  weight once per triangle;
- ``int32_tri`` / ``int64_tri``: the triangle of a slot by an int32
  division (the tree that divides in int64) or by an int64 one (the tree
  that divides in int32).

The forward's variant, timed on a tree with the g-less form (the single call
and B = 72 members, with g and without, beside ``as_is``):

- ``pair_gathers``: each corner's three values as one aligned pair
  (float2 / double2) and one scalar (``load3``), in place of three scalar
  loads.

A library but ``as_is``, ``int32_tri``, ``int64_tri`` and
``pair_gathers`` computes wrong outputs; only its time is read.  Per
library and row: the profiler's device µs of one call and each kernel's
share.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 tools/p1_div_cut_split.py [--root TREE] [--build DIR] [-o FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# the per-slot weight code of the two layouts: one member a thread (int64 index), and member
# groups (int32 index, every load of a chunk before the products)
OLD_W = ("        const bool keep = mask[tri];\n"
         "        const T wt = weight[tri];\n"
         "        const T w = keep ? wt : T(0);\n")
NEW_KEEP = "      keep[p] = mask[tri];\n"
NEW_WT = "        wt[m][p] = weight[m * weight_stride + tri];\n"
OLD_TRI = "        const int64_t tri = at / 3;\n"
NEW_TRI = "      const int tri = (int)((unsigned int)slot[p] / 3u);\n"
SCALAR = ("      v[m][k] = load_v ? V3<T>{__ldg(x), __ldg(x + 1), __ldg(x + 2)}"
          " : V3<T>{T(0), T(0), T(0)};\n"
          "      tc[m][k] = load_t ? V3<T>{__ldg(y), __ldg(y + 1), __ldg(y + 2)}"
          " : V3<T>{T(0), T(0), T(0)};\n")
PAIRS = ("      v[m][k] = load_v ? load3(x) : V3<T>{T(0), T(0), T(0)};\n"
         "      tc[m][k] = load_t ? load3(y) : V3<T>{T(0), T(0), T(0)};\n")
# a corner's three values as one aligned pair and one scalar, whichever way the pair lands
LOAD3 = """template <typename T>
__device__ __forceinline__ V3<T> load3(const T* __restrict__ x) {
  using Pair = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
  const bool lead = reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const Pair p = __ldg(reinterpret_cast<const Pair*>(lead ? x : x + 1));
  const T s = __ldg(lead ? x + 2 : x);
  return lead ? V3<T>{p.x, p.y, s} : V3<T>{s, p.x, p.y};
}

"""
PUT = "// Thread tid's three corner vectors into the block's (kTile, 3, 3) tile.\n"
# variant -> alternatives, each a list of (old, new) replacements; the first whose texts are
# all in the source is applied
VARIANTS = {
    "as_is": [[]],
    "no_mask_weight": [[(OLD_W, "        const T w = T(1);\n")],
                       [(NEW_KEEP, "      keep[p] = true;\n"),
                        (NEW_WT, "        wt[m][p] = T(1);\n")]],
    "mask_only": [[(OLD_W, "        const T w = mask[tri] ? T(1) : T(0);\n")],
                  [(NEW_WT, "        wt[m][p] = T(1);\n")]],
    "weight_only": [[(OLD_W, "        const T w = weight[tri];\n")],
                    [(NEW_KEEP, "      keep[p] = true;\n")]],
    "int32_tri": [[(OLD_TRI, "        const int tri = (int)((unsigned int)at / 3u);\n")]],
    "int64_tri": [[(NEW_TRI, "      const int64_t tri = (int64_t)slot[p] / 3;\n")]],
    "pair_gathers": [[(SCALAR, PAIRS), (PUT, LOAD3 + PUT),
                      ("#include <cstdint>\n", "#include <cstdint>\n#include <type_traits>\n")]],
}
FORWARD_LIBS = ("as_is", "pair_gathers")
# (row, members)
ROWS = (("weighted", 1), ("plain", 1), ("weighted", 8), ("plain", 8))
# (members, g written)
FORWARD = ((1, True), (1, False), (72, True), (72, False))


def variant_files(csrc: Path, name: str) -> dict | None:
    """The tree's sources with variant ``name`` applied; None where the tree has no such text."""
    files = {"tri_kernels.cu": (csrc / "tri_kernels.cu").read_text()}
    for header in csrc.glob("*.cuh"):
        files[header.name] = header.read_text()
    for edits in VARIANTS[name]:
        if all(any(old in text for text in files.values()) for old, _new in edits):
            for old, new in edits:
                hit = next(f for f, text in files.items() if old in text)
                files[hit] = files[hit].replace(old, new)
            return files
    return None


def build(files: dict, where: Path, flags: tuple, nvcc: str) -> Path:
    where.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (where / f).write_text(text)
    lib = where / "tri_kernels.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(where / "tri_kernels.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{where.name}: nvcc failed\n{proc.stderr[-3000:]}")
    return lib


def record(out: dict, library: str, row: str, dtype: str, members: int, call) -> None:
    import torch

    import chip_smoke as cs
    from time_surface_members import kernel_split

    timing = cs.time_call(torch, call)
    rec = {"library": library, "row": row, "dtype": dtype, "members": members,
           "device_us": timing["device_ms"] * 1e3,
           "kernels_us": {key: v * 1e3 for key, v in kernel_split(torch, call).items()}}
    print(json.dumps(rec), flush=True)
    out["rows"].append(rec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the tree whose sources and package are used (default: this one)")
    ap.add_argument("--build", type=Path, default=REPO / "membrane_solver_tpu_torch" / "_build"
                    / "p1_div_variants", help="where the variant libraries are built")
    ap.add_argument("-o", "--output", type=Path, help="also write the JSON rows here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("p1_div_cut_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import chip_smoke as cs

    root = args.root.resolve()
    sys.path.insert(0, str(root))
    for name in [m for m in sys.modules if m.startswith("membrane_solver_tpu_torch")]:
        del sys.modules[name]
    from membrane_solver_tpu_torch.kernels import _build
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    csrc = root / "membrane_solver_tpu_torch" / "csrc"
    sources = {name: variant_files(csrc, name) for name in VARIANTS}
    sources = {name: files for name, files in sources.items() if files is not None}
    out_dir = args.build / root.name
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda n: build(sources[n], out_dir / n, tk.KERNEL.flags, _build._nvcc()), sources)))
    entries = ("tri_p1_div", "tri_p1_div_members", "tri_p1_div_bwd", "tri_p1_div_bwd_members")
    signatures = {name: getattr(tk.build(), name).argtypes for name in entries}
    prob = cs.build_lane(torch, cs.load_fixture(cs.KOZLOV_FIXTURE)["protocol"],
                         torch.float64).problem()
    topo = prob.topo
    rows, valid, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
    T = rows.shape[0]
    rng = np.random.default_rng(31)
    base = prob.state.positions.detach()
    tilts = torch.as_tensor(0.3 * rng.standard_normal(tuple(base.shape)), device=cs.DEVICE)
    kept = tk._lib
    out = {"smi": cs.smi_line(), "root": str(root), "rows": []}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        gs = torch.as_tensor(rng.standard_normal((8, T, 3, 3)), dtype=dtype, device=cs.DEVICE)
        w = torch.as_tensor(rng.standard_normal((8, T)), dtype=dtype, device=cs.DEVICE)
        mask = valid & (torch.as_tensor(rng.random(T), device=cs.DEVICE) < 0.8)
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            for entry, argtypes in signatures.items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
            tk._lib = lib
            for label, B in ROWS:
                if label == "plain" and name != "as_is":
                    continue

                def call(label=label, B=B):
                    if label == "plain":
                        return vs.launch(gs[0], csr) if B == 1 else vs.launch_members(gs, csr)
                    if B == 1:
                        return tk.launch_p1_div_bwd(gs[0], mask, w[0], csr)
                    return tk.launch_p1_div_bwd_members(gs, mask, w, csr)

                record(out, name, label, dname, B, call)
            if name not in FORWARD_LIBS or not hasattr(tk, "DIV_GROUPS"):
                continue
            for B, grads in FORWARD:
                pos = torch.stack([base.to(dtype) * (1 + 0.001 * m) for m in range(B)])
                tl = torch.stack([tilts.to(dtype) * (1 - 0.01 * m) for m in range(B)])

                def call(pos=pos.contiguous(), tl=tl.contiguous(), B=B, grads=grads):
                    if B == 1:
                        return tk.launch_p1_divergence(pos[0], tl[0], rows, valid, grads=grads)
                    return tk.launch_p1_divergence_members(pos, tl, rows, valid, grads=grads)

                record(out, name, f"forward g={grads}", dname, B, call)
    tk._lib = kept
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
