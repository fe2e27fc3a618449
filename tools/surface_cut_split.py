#!/usr/bin/env python3
"""Where kernel 2's member launches spend their time: the tri_kernels library rebuilt with parts cut out.

Builds ``csrc/tri_kernels.cu`` (with the shared headers) once as it is and
once per cut, each into its own directory under ``--build`` (one ``nvcc``
each, all started together), and times each library's
``tri_surface_energy_members`` (and the single ``tri_surface_energy`` with
the gradient) at the kozlov L3 lane's shapes, through the same calls as
``tools/time_surface_members.py``.  The cuts, each a text replacement in
the source (the run fails if the text is not found):

- ``no_interior``: the in-tile sums of the tiles' interior vertices are
  skipped (their vertex rows are left unwritten);
- ``no_boundary``: the boundary corners' rows are not written to the
  scratch (the vertex sum reads what it holds);
- ``slab``: every corner's row is written to the scratch as the single
  call writes it, a coalesced slab, in place of the boundary rows alone
  (the vertex sum still reads only the boundary vertices' rows, so this
  one computes the right gradient);
- ``no_reduce``: no block tree, no partials, no counter and no last block;
- ``blocks12``: a variant, not a cut: the kernel's launch bounds ask for
  12 blocks a multiprocessor where a block takes one member (the compiler
  then holds it to 40 registers), and none where it takes more.

A cut library but ``slab`` and ``blocks12`` computes wrong outputs; only its
time is read.
Per library and row: the profiler's device µs of one call and each
kernel's share.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 tools/surface_cut_split.py [--build DIR] [-o FILE]
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
MASKED_STORE = "            if (mask & (1u << k)) store(dc, 3 * t + k, d[m][k]);\n"
CUTS = {
    "as_is": [],
    "no_interior": [("        if (iv >= 0) {\n          vertex_sum::add_interior",
                     "        if (false) {\n          vertex_sum::add_interior"),
                    ("for (int j = interior_lo + tid + kTile; j < interior_hi; j += kTile) {",
                     "for (int j = interior_hi; j < interior_hi; j += kTile) {")],
    "no_boundary": [(MASKED_STORE, "")],
    "slab": [(MASKED_STORE, ""),
             ("      if (a.corner_mask == nullptr) {\n"
              "        store_slab(dc + 9 * (int64_t)first, s_dc, 9 * here);\n"
              "      } else {",
              "      store_slab(dc + 9 * (int64_t)first, s_dc, 9 * here);\n"
              "      if (a.corner_mask != nullptr) {")],
    "no_reduce": [("    if (block_sum::grid_sums<kTile, kM>(e_thread, here_m, "
                   "a.partials + first_member * gridDim.x,",
                   "    for (int m = 0; m < kM; ++m) {\n"
                   "      if (e_thread[m] == 12345.0) a.partials[blockIdx.x] = e_thread[m];\n"
                   "    }\n"
                   "    if (false && block_sum::grid_sums<kTile, kM>(e_thread, here_m, "
                   "a.partials + first_member * gridDim.x,")],
    "blocks12": [("__global__ void __launch_bounds__(kTile) surface_kernel(",
                  "__global__ void __launch_bounds__(kTile, kM == 1 ? 12 : 1) surface_kernel(")],
}
# (row, dtype, members, with the gradient, members a block)
ROWS = (("single gradient", "float32", 1, True, 1),
        ("member gradient", "float32", 8, True, 1), ("member gradient", "float32", 8, True, 2),
        ("member gradient", "float64", 8, True, 1), ("member gradient", "float64", 9, True, 1),
        ("member energy", "float32", 8, False, 1), ("member energy", "float32", 72, False, 2))


def build(name: str, out: Path) -> Path:
    """The library with cut ``name`` applied, in ``out / name``."""
    sys.path.insert(0, str(REPO))
    from membrane_solver_tpu_torch.kernels import _build
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    files = {"tri_kernels.cu": (CSRC / "tri_kernels.cu").read_text()}
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
    lib = where / "tri_kernels.so"
    proc = subprocess.run([_build._nvcc(), *tk.KERNEL.flags, "-o", str(lib),
                           str(where / "tri_kernels.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cut {name}: nvcc failed\n{proc.stderr[-3000:]}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", type=Path, default=REPO / "membrane_solver_tpu_torch" / "_build"
                    / "surface_cuts", help="where the cut libraries are built")
    ap.add_argument("-o", "--output", type=Path, help="also write the JSON rows here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("surface_cut_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import chip_smoke as cs
    import time_surface_members as tool
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    signatures = {name: getattr(tk.build(), name).argtypes
                  for name in ("tri_surface_energy", "tri_surface_energy_members")}
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(zip(CUTS, pool.map(lambda n: build(n, args.build), CUTS)))
    mn = cs.build_lane(torch, cs.load_fixture(cs.KOZLOV_FIXTURE)["protocol"], torch.float64)
    topo = mn.problem().topo
    rows, valid, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
    T = rows.shape[0]
    kept = tk._lib
    out = {"smi": cs.smi_line(), "rows": []}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in signatures.items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        tk._lib = lib
        for label, dname, B, grad, group in ROWS:
            dtype = getattr(torch, dname)
            base = mn.problem().state.positions.detach().to(dtype)
            tension = topo.tri_surface_tension.to(dtype)
            pos = torch.stack([base * (1 + 0.001 * m) for m in range(B)]).contiguous()
            ws = tk.MemberWorkspace(B, T, dtype, cs.DEVICE)
            one_ws = tk.Workspace(T, dtype, cs.DEVICE)

            def call(pos=pos, tension=tension, ws=ws, one_ws=one_ws, grad=grad, group=group,
                     single=label.startswith("single")):
                if single:
                    return tk.launch_surface_energy(pos[0], rows, valid, tension, csr, one_ws,
                                                    grad)
                return tk.launch_surface_energy_members(pos, rows, valid, tension, csr, ws, grad,
                                                        group=group)

            timing = cs.time_call(torch, call)
            rec = {"library": name, "row": label, "dtype": dname, "members": B, "group": group,
                   "device_us": timing["device_ms"] * 1e3,
                   "kernels_us": {key: v * 1e3
                                  for key, v in tool.kernel_split(torch, call).items()}}
            print(json.dumps(rec), flush=True)
            out["rows"].append(rec)
    tk._lib = kept
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
