"""Card only: kernel 2's grouped member launch against single launches, bit for bit.

``tri_surface_energy_members`` runs a group of members in each block over
one 128-triangle tile; member m of a B-member call must be the bits of
``tri_surface_energy`` on member m alone: the energy and, with the
gradient, the vertex gradient, whose tiles' interior vertices the member
launch sums in its triangle pass where the single call sends every corner
through the scratch.  For every B here (a partial last group included),
the tension shared or one per member, float32 and float64, on random
triangles (T = 301: a member's corner slab off a 16-byte boundary; T =
21,504, the kozlov L3 count) and on two grids of 21,504 triangles: 112 x 96
cells, whose tiles hold few whole vertex fans (every corner through the
scratch, as on the random triangles), and 16 x 672, where three quarters
of the corners are interior vertices' (the in-tile sums); and at every
group the library takes, the default group's bits.
Skips where there is no CUDA device.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from membrane_solver_tpu_torch.device.state import corner_csr
from membrane_solver_tpu_torch.kernels import tri_kernels as tk


def _members() -> list:
    """1, 2, the group less one, the group and one more, the last ungrouped width, the first
    grouped one and the next (a partial last group), the sweep's 8, the Armijo tail's 9 and
    the sweep tail's 72 rows."""
    M, S = tk.GROUP, tk.SOLO
    return sorted({1, 2, M - 1, M, M + 1, S, S + 1, S + 2, 8, 9, 72} - {0})


def _grid_rows(nx: int, ny: int) -> np.ndarray:
    """Two triangles per cell of an nx x ny grid, in row order: tiles with interior vertices."""
    v = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    a, b, c, d = v[:-1, :-1].ravel(), v[:-1, 1:].ravel(), v[1:, :-1].ravel(), v[1:, 1:].ravel()
    return np.stack([np.stack([a, b, d], 1), np.stack([a, d, c], 1)], 1).reshape(-1, 3)


def _mesh(mesh: str, rng) -> tuple:
    if mesh.startswith("grid"):
        rows = _grid_rows(*(int(x) for x in mesh.split("_")[1].split("x")))
        return rows, int(rows.max()) + 1
    T = int(mesh.split("_")[1])
    nv = T // 2 + 9
    rows = rng.integers(0, nv, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (nv - 2)) % nv
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (nv - 2)) % nv
    return rows, nv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mesh", ["random_301", "random_21504", "grid_112x96", "grid_16x672"])
def test_member_launch_is_single_launches_bits(mesh, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(len(mesh))
    rows_np, nv = _mesh(mesh, rng)
    T = rows_np.shape[0]
    rows = torch.as_tensor(rows_np, device="cuda")
    valid = torch.as_tensor(rng.uniform(size=T) > 0.05, device="cuda")
    csr = corner_csr(rows, nv)
    one_ws = tk.Workspace(T, dtype, "cuda")

    def f(*shape, lo=None):
        x = rng.standard_normal(shape) if lo is None else rng.uniform(lo, 2.0, shape)
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    for B in _members():
        pos, tensions = f(B, nv, 3), f(B, T, lo=0.5)
        ws = tk.MemberWorkspace(B, T, dtype, "cuda")
        for shared in (True, False):
            tension = tensions[0].contiguous() if shared else tensions
            for grad in (False, True):
                e, dpos = tk.launch_surface_energy_members(pos, rows, valid, tension, csr, ws,
                                                           grad)
                for m in range(B):
                    e1, g1 = tk.launch_surface_energy(pos[m].clone(), rows, valid,
                                                      tension if shared else tension[m].clone(),
                                                      csr, one_ws, grad)
                    assert torch.equal(e[m:m + 1], e1), (B, shared, grad, m)
                    if grad:
                        assert torch.equal(dpos[m], g1), (B, shared, grad, m)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [5, 9, 72])
def test_every_group_gives_the_default_groups_bits(B):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(B)
    rows_np, nv = _mesh("grid_16x672", rng)
    T = rows_np.shape[0]
    rows = torch.as_tensor(rows_np, device="cuda")
    valid = torch.ones(T, dtype=torch.bool, device="cuda")
    csr = corner_csr(rows, nv)
    ws = tk.MemberWorkspace(B, T, torch.float64, "cuda")
    pos = torch.as_tensor(rng.standard_normal((B, nv, 3)), device="cuda")
    tension = torch.as_tensor(rng.uniform(0.5, 2.0, (B, T)), device="cuda")
    want = tk.launch_surface_energy_members(pos, rows, valid, tension, csr, ws, True)
    for group in range(1, tk.build().tri_surface_max_group() + 1):
        got = tk.launch_surface_energy_members(pos, rows, valid, tension, csr, ws, True,
                                               group=group)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), group
    with pytest.raises(RuntimeError, match="cudaError"):
        tk.launch_surface_energy_members(pos, rows, valid, tension, csr, ws, True, group=0)
    torch.cuda.synchronize()
