#!/usr/bin/env python3
"""SHA-256 of the frozen-tilt entry point's outputs on seeded inputs, one GPU.

Shows that two trees of the PyTorch port give the frozen-tilt energy and
vertex gradients to the same bits: run it once per tree (``--root``, the
tree whose ``membrane_solver_tpu_torch`` is imported and built) in one
process each, and compare the printed digests.  Inputs: T = 21,504 seeded
distinct-corner triangles over 10,817 vertices (the kozlov L3 sizes),
seeded float32 tilts, P1 gradients, payload and moduli; outputs: the
energy of the energy-only call, then the energy and both vertex gradients
of the energy-plus-gradient call.  ``sha256_grid`` does the same on a
112 x 96 grid of cells, two triangles each, in row order (21,504
triangles over 10,961 vertices): its 128-triangle tiles have interior
vertices, which a gradient call sums inside the triangle pass.

Usage (on a machine with a CUDA GPU)::

    python3 tools/frozen_tilt_digest.py [--root TREE]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
T, NV = 21_504, 10_817


def seeded_inputs(seed: int = 7):
    """(tri_rows int64, t_in, t_out, g, payload, k_vec) as numpy."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, NV, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (NV - 2)) % NV
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (NV - 2)) % NV
    f32 = np.float32
    return (rows, rng.standard_normal((NV, 3)).astype(f32),
            rng.standard_normal((NV, 3)).astype(f32), rng.standard_normal((T, 3, 3)).astype(f32),
            np.abs(rng.standard_normal((T, 20))).astype(f32), rng.uniform(0.5, 2.0, 6).astype(f32))


def grid_rows(nx: int, ny: int) -> np.ndarray:
    """(2 nx ny, 3) int64 rows: two triangles per cell of an nx x ny grid, in row order."""
    v = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    a, b, c, d = v[:-1, :-1].ravel(), v[:-1, 1:].ravel(), v[1:, :-1].ravel(), v[1:, 1:].ravel()
    return np.stack([np.stack([a, b, d], 1), np.stack([a, d, c], 1)], 1).reshape(-1, 3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the tree to import (default: this one)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("frozen_tilt_digest: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from membrane_solver_tpu_torch.device.state import corner_csr
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    def digest(rows, nv, t_in, t_out, g, pay, k):
        csr = corner_csr(rows, nv)
        ws = ft.Workspace(rows.shape[0], rows.device)
        e_only, _, _ = ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=False)
        outs = (e_only,) + ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=True)
        torch.cuda.synchronize()
        return (hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in outs)).hexdigest(),
                float(outs[1]))

    arrays = [torch.from_numpy(a).cuda() for a in seeded_inputs()]
    sha, energy = digest(arrays[0], NV, *arrays[1:])
    grid = torch.from_numpy(grid_rows(112, 96)).cuda()
    nv_grid = int(grid.max()) + 1
    rng = np.random.default_rng(11)
    t_in, t_out = (torch.from_numpy(rng.standard_normal((nv_grid, 3)).astype(np.float32)).cuda()
                   for _ in range(2))
    sha_grid, _e = digest(grid, nv_grid, t_in, t_out, *arrays[3:])
    print(json.dumps({"root": str(args.root), "package": ft.__file__,
                      "library": ft.KERNEL.library_path().name, "energy": energy,
                      "sha256": sha, "sha256_grid": sha_grid}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
