#!/usr/bin/env python3
"""Where kernel 1's launches spend their time: the frozen-tilt library rebuilt with parts cut out.

Builds ``csrc/frozen_tilt.cu`` (with the shared headers) once as it is and
once per cut, each into its own directory under ``--build`` (one ``nvcc``
each, all started together), and times each library's
``frozen_tilt_vertex`` (the single rows) and ``frozen_tilt_members`` at the
kozlov L3 lane's shapes, float32, seeded inputs (``chip_smoke._ft_inputs``),
through the same calls as ``tools/time_frozen_tilt_members.py``.  The cuts, each a text replacement
in the source (the run fails if the text is not found):

- ``no_gather``: the corner tilts are not loaded (a value made from the row
  index takes their place);
- ``no_compute``: the energy-only arithmetic returns at once;
- ``no_reduce``: no block tree, no partials, no counter and no last block
  (each thread keeps its energy alive with a store that never happens).

A cut library computes wrong energies; only its time is read.  Per library
and row: the profiler's device µs of one call and each kernel's share.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 tools/frozen_tilt_cut_split.py [--build DIR] [-o FILE]
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
CSRC = REPO / "membrane_solver_tpu_torch" / "csrc"
CUTS = {
    "as_is": [],
    "no_gather": [("load ? tin[m * nv * 3 + 3 * r[c] + x] : 0.0f",
                   "__int_as_float((int)r[c] + m)"),
                  ("load ? tout[m * nv * 3 + 3 * r[c] + x] : 0.0f",
                   "__int_as_float((int)r[c] - m)")],
    "no_compute": [("  const float k_in = k[0], k_out = k[1], kap_in = k[2], kap_out = k[3];\n",
                    "  if (!kGrad) return a[0] + b[1] + p[0] + g[0];\n"
                    "  const float k_in = k[0], k_out = k[1], kap_in = k[2], kap_out = k[3];\n")],
    "no_reduce": [("  if (block_sum::grid_sums<kThreads, kM>(e_thread, here_m, partials, counter, "
                   "total)) {",
                   "  for (int m = 0; m < kM; ++m) {\n"
                   "    if (e_thread[m] == 12345.0) partials[blockIdx.x] = e_thread[m];\n"
                   "  }\n  if (false) {")],
}
# (row, members, g and payload shared, with the gradient, members a block)
ROWS = (("single energy", 1, True, False, 1), ("single gradient", 1, True, True, 1),
        ("shared energy", 11, True, False, 4), ("shared energy", 9, True, False, 3),
        ("per-member energy", 9, False, False, 1), ("per-member gradient", 9, False, True, 1))


def build(name: str, out: Path) -> Path:
    """The library with cut ``name`` applied, in ``out / name``."""
    sys.path.insert(0, str(REPO))
    from membrane_solver_tpu_torch.kernels import _build

    files = {"frozen_tilt.cu": (CSRC / "frozen_tilt.cu").read_text()}
    for header in CSRC.glob("*.cuh"):
        files[header.name] = header.read_text()
    for old, new in CUTS[name]:
        hits = [f for f, text in files.items() if old in text]
        if not hits:
            raise RuntimeError(f"cut {name}: {old!r} is not in the sources")
        files[hits[0]] = files[hits[0]].replace(old, new)
    where = out / name
    where.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (where / f).write_text(text)
    lib = where / "frozen_tilt.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(where / "frozen_tilt.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cut {name}: nvcc failed\n{proc.stderr[-3000:]}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", type=Path, default=REPO / "membrane_solver_tpu_torch" / "_build"
                    / "cuts", help="where the cut libraries are built")
    ap.add_argument("-o", "--output", type=Path, help="also write the JSON rows here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("frozen_tilt_cut_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import chip_smoke as cs
    import time_frozen_tilt_members as tool
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(zip(CUTS, pool.map(lambda n: build(n, args.build), CUTS)))
    mn = cs.build_lane(torch, cs.load_fixture(cs.KOZLOV_FIXTURE)["protocol"], torch.float64)
    topo = mn.problem().topo
    rows, csr = topo.tri_rows, topo.corner_csr()
    T, N = rows.shape[0], mn.problem().n_vertices
    t_in, t_out, g1, pay1, k = cs._ft_inputs(torch, rows, N, 13)
    ws = ft.Workspace(T, rows.device)
    out = {"smi": cs.smi_line(), "rows": []}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.frozen_tilt_members.argtypes = [ptr] * 18 + [i32, i32, i32, i32, ctypes.c_int64,
                                                          ctypes.c_int64, i32, ptr]
        lib.frozen_tilt_members.restype = i32
        lib.frozen_tilt_vertex.argtypes = [ptr] * 14 + [i32, i32, i32, ptr]
        lib.frozen_tilt_vertex.restype = i32
        ft._lib = lib
        for label, B, shared, grad, group in ROWS:
            a = torch.stack([t_in + 0.01 * m for m in range(B)]).contiguous()
            b = torch.stack([t_out - 0.01 * m for m in range(B)]).contiguous()
            g = g1 if shared else torch.stack([g1 * (1 + 0.01 * m)
                                               for m in range(B)]).contiguous()
            pay = pay1 if shared else torch.stack([pay1 * (1 + 0.01 * m)
                                                   for m in range(B)]).contiguous()

            def call(a=a, b=b, g=g, pay=pay, grad=grad, group=group,
                     single=label.startswith("single")):
                if single:
                    return ft.launch(a[0], b[0], rows, csr, g, pay, k, ws, grad=grad)
                return tool.raw_call(torch, ft, a, b, rows, csr, g, pay, k, ws, grad, group)

            timing = cs.time_call(torch, call)
            rec = {"library": name, "row": label, "members": B, "group": group,
                   "device_us": timing["device_ms"] * 1e3,
                   "kernels_us": {key: v * 1e3
                                  for key, v in tool.kernel_split(torch, call).items()}}
            print(json.dumps(rec), flush=True)
            out["rows"].append(rec)
    ft._lib = None
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
