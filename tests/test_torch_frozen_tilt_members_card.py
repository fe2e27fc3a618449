"""Card only: kernel 1's grouped member launch against single launches, bit for bit.

``frozen_tilt_members`` runs a group of up to ``MAX_GROUP`` members in each
block; member m of a B-member call must be the bits of ``frozen_tilt_vertex``
on member m alone, for every B (a partial last group included), with g and
the payload shared or one per member (off a 16-byte boundary at T = 301),
with and without the gradient: a member gradient's in-tile vertex sums
(the grid's tiles have interior vertices) the bits of a single call, which
sends every corner through the scratch.  Skips where there is no CUDA
device.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from membrane_solver_tpu_torch.device.state import corner_csr
from membrane_solver_tpu_torch.kernels import frozen_tilt as ft


def _members(M: int) -> list:
    return sorted({1, 2, 3, M - 1, M, M + 1, 9, 11, 17} - {0})


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _grid_rows(nx: int, ny: int) -> np.ndarray:
    """Two triangles per cell of an nx x ny grid, in row order: tiles with interior vertices."""
    v = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    a, b, c, d = v[:-1, :-1].ravel(), v[:-1, 1:].ravel(), v[1:, :-1].ravel(), v[1:, 1:].ravel()
    return np.stack([np.stack([a, b, d], 1), np.stack([a, d, c], 1)], 1).reshape(-1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["random_301", "random_21504", "grid_112x96"])
def test_member_launch_is_single_launches_bits(mesh):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(len(mesh))
    if mesh.startswith("grid"):
        rows_np = _grid_rows(112, 96)
        T, nv = rows_np.shape[0], int(rows_np.max()) + 1
    else:
        T = int(mesh.split("_")[1])
        nv = T // 2 + 9
        rows_np = rng.integers(0, nv, size=(T, 3))
        rows_np[:, 1] = (rows_np[:, 0] + 1 + rows_np[:, 1] % (nv - 2)) % nv
        rows_np[:, 2] = (rows_np[:, 1] + 1 + rows_np[:, 2] % (nv - 2)) % nv
    rows = torch.as_tensor(rows_np, device="cuda")
    csr = corner_csr(rows, nv)
    ws = ft.Workspace(T, rows.device)

    def f(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device="cuda")

    k = torch.as_tensor(rng.uniform(0.5, 2.0, 6), dtype=torch.float32, device="cuda")
    for B in _members(ft.MAX_GROUP):
        a, b, g_all, pay_all = f(B, nv, 3), f(B, nv, 3), f(B, T, 3, 3), f(B, T, 20).abs()
        for shared in (True, False):
            g = g_all[0].contiguous() if shared else g_all
            pay = pay_all[0].contiguous() if shared else pay_all
            for grad in (False, True):
                got = ft.launch_members(a, b, rows, csr, g, pay, k, ws, grad=grad)
                for m in range(B):
                    one = ft.launch(a[m].clone(), b[m].clone(), rows, csr,
                                    g if shared else g[m].clone(),
                                    pay if shared else pay[m].clone(), k, ws, grad=grad)
                    assert _same_bits(got[0][m:m + 1], one[0]), (B, shared, grad, m)
                    if grad:
                        assert _same_bits(got[1][m], one[1]) and _same_bits(got[2][m], one[2]), \
                            (B, shared, grad, m)
