"""Kernel 2's member axis on the CPU: its twin against the JAX package, and the tile tables.

- ``tri_kernels.surface_energy_members_reference`` (the CPU path and the
  card's oracle of ``tri_surface_energy_members``) at B = 1, 3, 5 and 9
  members, with the tension shared or one per member, the energy alone and
  with the vertex gradient, held member by member against the JAX
  package's ``surface_corner_grads_pallas`` in interpret mode (the JAX
  kernel tests' CPU route) at float32, with that file's tolerances: the
  energy rel 2e-6, the vertex gradient 2e-5 of its max.  The Pallas corner
  gradients are the negated area gradient (ROADMAP C2), so the JAX side's
  vertex gradient is minus their scatter.
- ``vertex_sum.tile_sums``, the in-tile sums' tables that kernel 1's and
  kernel 2's member gradients share (moved from ``kernels/frozen_tilt``),
  on the kozlov lane at L0, L1 and L2: the tables built anew in numpy from
  the corner CSR (unchanged for kernel 1), one object kept per CSR for
  both kernels, and the two passes' sum (``tile_sums_reference``) the
  vertex sum's twin in bits; and which member gradients sum in their tiles
  (``TileSums.in_tile``: at least half the corners interior vertices').

The member launch against single launches, bit for bit, is card-only:
``tests/test_torch_surface_members_card.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import make_minimizer

from membrane_solver_tpu.pallas_kernels import surface_corner_grads_pallas
from membrane_solver_tpu_torch.device.state import corner_csr
from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
from membrane_solver_tpu_torch.kernels import tri_kernels as tk
from membrane_solver_tpu_torch.kernels import vertex_sum as vs

T, NV = 200, 90


def _inputs(B: int, per_member: bool, seed: int = 11):
    """The JAX kernel tests' triangles (the last 7 invalid), B members' positions (member m
    the seeded ones scaled by 1 + 0.01 m and jittered), tensions shared or per member."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, NV, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (NV - 2)) % NV
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (NV - 2)) % NV
    base = rng.standard_normal((NV, 3))
    pos = np.stack([base * (1 + 0.01 * m) + 1e-3 * rng.standard_normal((NV, 3))
                    for m in range(B)]).astype(np.float32)
    valid = np.ones(T, dtype=bool)
    valid[-7:] = False
    shape = (B, T) if per_member else (T,)
    tension = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return pos, rows, valid, tension


def _jax_member(pos, rows, valid, tension):
    """(energy, vertex gradient) of one member from the Pallas kernel's per-triangle terms."""
    gamma = np.where(valid, tension, np.float32(0.0))
    e, g0, g1, g2 = surface_corner_grads_pallas(*(jnp.asarray(pos[rows[:, k]]) for k in range(3)),
                                                jnp.asarray(gamma))
    grad = np.zeros((NV, 3))
    for k, g in enumerate((g0, g1, g2)):
        np.add.at(grad, rows[:, k], -np.asarray(g, dtype=np.float64))
    return float(np.sum(np.asarray(e, dtype=np.float64))), grad


@pytest.mark.parametrize("grad", [False, True], ids=["energy", "gradient"])
@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "per_member"])
@pytest.mark.parametrize("B", [1, 3, 5, 9])
def test_member_twin_matches_pallas_per_member(B, per_member, grad):
    pos, rows, valid, tension = _inputs(B, per_member)
    t_rows = torch.as_tensor(rows)
    csr = corner_csr(t_rows, NV)
    e, dpos = tk.surface_energy_members_reference(
        torch.as_tensor(pos), t_rows, torch.as_tensor(valid), torch.as_tensor(tension), csr, grad)
    assert e.shape == (B,) and (dpos is None) == (not grad)
    for m in range(B):
        want_e, want_g = _jax_member(pos[m], rows, valid, tension[m] if per_member else tension)
        assert abs(float(e[m]) - want_e) <= 2e-6 * abs(want_e), (m, float(e[m]), want_e)
        if grad:
            err = float(np.max(np.abs(dpos[m].numpy().astype(np.float64) - want_g)))
            assert err <= 2e-5 * float(np.max(np.abs(want_g))), (m, err)


def _tables_from_csr(csr) -> dict:
    """``TileSums``' tables built anew in numpy from the CSR: per vertex the tiles of its
    corners (interior: one tile), each tile's interior vertices in vertex order then the
    boundary ones, and per triangle the corners of boundary vertices."""
    offsets, slots = csr.offsets.numpy(), csr.slots.numpy()
    rows = csr.rows.numpy()
    tiles = -(-rows.shape[0] // vs.TILE)
    bucket = []
    for v in range(csr.n_rows):
        own = {int(s) // (3 * vs.TILE) for s in slots[offsets[v]:offsets[v + 1]]}
        bucket.append(own.pop() if len(own) == 1 else tiles)
    bucket = np.asarray(bucket)
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket, minlength=tiles + 1)
    interior = bucket < tiles
    mask = ((~interior[rows]).astype(np.int64) << np.arange(3)).sum(1)
    return {"interior": interior.astype(np.uint8), "tile_vertices": order.astype(np.int32),
            "tile_offsets": np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            "corner_mask": mask.astype(np.uint8)}


@pytest.mark.parametrize("refines", [0, 1, 2], ids=["L0", "L1", "L2"])
def test_tile_sums_tables_on_the_kozlov_lane(refines):
    topo = make_minimizer(True, refines=refines, dtype=torch.float64).problem().topo
    csr = topo.corner_csr()
    ts = vs.tile_sums(csr)
    assert vs.tile_sums(csr) is ts and ft.BLOCK == tk.TILE == vs.TILE
    want = _tables_from_csr(csr)
    for name, table in want.items():
        got = getattr(ts, name)
        assert got.dtype == torch.as_tensor(table).dtype, name
        assert np.array_equal(got.numpy(), table), name
    if refines:
        assert int(ts.interior.sum()) > 0
    rng = np.random.default_rng(refines)
    vals = torch.as_tensor(rng.standard_normal((topo.tri_rows.shape[0], 3, 3)))
    got = vs.tile_sums_reference(vals, csr)
    assert torch.equal(got.view(torch.int64), vs.reference(vals, csr).view(torch.int64))


def _grid_rows(nx: int, ny: int) -> np.ndarray:
    """Two triangles per cell of an nx x ny grid, in row order."""
    v = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    a, b, c, d = v[:-1, :-1].ravel(), v[:-1, 1:].ravel(), v[1:, :-1].ravel(), v[1:, 1:].ravel()
    return np.stack([np.stack([a, b, d], 1), np.stack([a, d, c], 1)], 1).reshape(-1, 3)


@pytest.mark.parametrize("mesh,want", [("grid_112x96", False), ("grid_16x672", True),
                                       ("kozlov_L2", True)])
def test_in_tile_follows_the_interior_corner_share(mesh, want):
    """Kernel 2's member gradient sums in its tiles where at least half the corners are
    interior vertices' (a 16-cell-wide grid: three quarters; kozlov L2: 71%), and sends every
    corner through the scratch where the tiles hold few whole fans (a 112-cell-wide grid: 1%)."""
    if mesh.startswith("grid"):
        rows = torch.as_tensor(_grid_rows(*(int(x) for x in mesh.split("_")[1].split("x"))))
        csr = corner_csr(rows, int(rows.max()) + 1)
    else:
        csr = make_minimizer(True, refines=2, dtype=torch.float64).problem().topo.corner_csr()
    ts = vs.tile_sums(csr)
    interior = ts.interior.bool()[csr.rows]
    assert ts.in_tile == want == bool(2 * int(interior.sum()) >= interior.numel())
