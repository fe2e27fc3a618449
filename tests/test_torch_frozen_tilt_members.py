"""Kernel 1's member axis: the twin ``reference_members`` against the JAX package, member by member.

On the CPU ``frozen_tilt_energy_members`` runs its twin, ``reference_members``:
the single twin once per member.  Here each member of B stacked tilt pairs,
with g and the payload shared ((T, 3, 3), (T, 20)) or one per member, is
held against the JAX package's ``fused_tilt_energy`` on that member's
gathered corners, run as the JAX package's own tests run it on the CPU
(the Pallas kernel in interpret mode): the energy and both vertex
gradients (``jax.grad`` with respect to the vertex tilts).  Bars: float32 at
the JAX kernel tests' bounds (energy rel 1e-6, gradient 5e-6 * max|g|,
``tests/test_pallas_frozen_tilt.py``), float64 at 1e-12.  The grouped CUDA
launch is held to single launches on the card
(``tests/test_torch_frozen_tilt_members_card.py``, ``chip_smoke.py``
phases 56-57).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from membrane_solver_tpu.pallas_kernels import frozen_tilt as jft
from membrane_solver_tpu_torch.device.state import corner_csr, problem_from_numpy
from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
from membrane_solver_tpu_torch.kernels import vertex_sum as vs

T = 301
BOUNDS = {np.float32: (1e-6, 5e-6), np.float64: (1e-12, 1e-12)}


def _member_inputs(B: int, dtype, seed: int = 11):
    """(t_in, t_out (B, N, 3), rows (T, 3), g (B, T, 3, 3), payload (B, T, 20), k_vec (6,))."""
    rng = np.random.default_rng(seed)
    nv = T // 2 + 9
    rows = rng.integers(0, nv, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (nv - 2)) % nv
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (nv - 2)) % nv
    return (rng.standard_normal((B, nv, 3)).astype(dtype),
            rng.standard_normal((B, nv, 3)).astype(dtype), rows,
            rng.standard_normal((B, T, 3, 3)).astype(dtype),
            np.abs(rng.standard_normal((B, T, 20))).astype(dtype),
            rng.uniform(0.5, 2.0, 6).astype(dtype))


@functools.lru_cache(maxsize=None)
def _jax_energy_and_grads():
    """jit of (energy, dE/dt_in, dE/dt_out) of vertex tilts through ``fused_tilt_energy``."""

    def energy(a, b, rows, g, pay, k):
        return jft.fused_tilt_energy(a[rows], b[rows], g, pay, k)

    return jax.jit(jax.value_and_grad(energy, argnums=(0, 1)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_member"])
@pytest.mark.parametrize("B", [1, 2, 5, 11])
def test_reference_members_match_jax_pallas_kernel_interpret(monkeypatch, B, shared, dtype):
    monkeypatch.setenv("MEMBRANE_SOLVER_PALLAS", "1")
    t_in, t_out, rows, g, pay, k = _member_inputs(B, dtype)
    if shared:
        g, pay = g[0], pay[0]
    csr = corner_csr(torch.as_tensor(rows), t_in.shape[1])
    e, gin, gout = ft.reference_members(
        *(torch.as_tensor(x) for x in (t_in, t_out, rows)), csr,
        *(torch.as_tensor(x) for x in (g, pay, k)), grad=True)
    e_only, none_in, none_out = ft.reference_members(
        *(torch.as_tensor(x) for x in (t_in, t_out, rows)), csr,
        *(torch.as_tensor(x) for x in (g, pay, k)))
    assert none_in is None and none_out is None and torch.equal(e_only, e)
    assert e.shape == (B,) and gin.shape == gout.shape == t_in.shape
    e_rtol, g_rtol = BOUNDS[dtype]
    fn = _jax_energy_and_grads()
    j_rows = jnp.asarray(rows, jnp.int32)
    for m in range(B):
        g_m, pay_m = (g, pay) if shared else (g[m], pay[m])
        want_e, (want_in, want_out) = fn(jnp.asarray(t_in[m]), jnp.asarray(t_out[m]), j_rows,
                                         jnp.asarray(g_m), jnp.asarray(pay_m), jnp.asarray(k))
        assert float(e[m]) == pytest.approx(float(want_e), rel=e_rtol)
        for got, want in ((gin[m], want_in), (gout[m], want_out)):
            want = np.asarray(want, np.float64)
            scale = float(np.max(np.abs(want)))
            assert float(np.max(np.abs(got.numpy().astype(np.float64) - want))) <= g_rtol * scale


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_member"])
def test_member_entry_point_gradients_scale_by_each_members_cotangent(shared):
    """``frozen_tilt_energy_members`` on the CPU: the twin's energies, and a backward that scales
    member m's gradients by its own cotangent."""
    t_in, t_out, rows, g, pay, k = (torch.as_tensor(x) for x in _member_inputs(3, np.float64))
    if shared:
        g, pay = g[0], pay[0]
    csr = corner_csr(rows, t_in.shape[1])
    a, b = t_in.clone().requires_grad_(True), t_out.clone().requires_grad_(True)
    e = ft.frozen_tilt_energy_members(a, b, rows, csr, g, pay, k)
    ct = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    (e * ct).sum().backward()
    want_e, want_in, want_out = ft.reference_members(t_in, t_out, rows, csr, g, pay, k, grad=True)
    assert torch.equal(e.detach(), want_e)
    assert torch.equal(a.grad, ct[:, None, None] * want_in)
    assert torch.equal(b.grad, ct[:, None, None] * want_out)


@pytest.mark.parametrize("B", list(range(1, 18)) + [64, 65535])
def test_group_size_splits_members_into_even_groups(B):
    """A block's member group: with shared g and payload and B above MAX_GROUP, the fewest
    groups of at most MAX_GROUP, as even as they go, the last one possibly partial; else one
    member a block."""
    assert ft.group_size(B, shared=False) == 1
    group = ft.group_size(B)
    if B <= ft.MAX_GROUP:
        assert group == 1
        return
    groups = -(-B // group)
    assert 1 < group <= ft.MAX_GROUP
    assert groups == -(-B // ft.MAX_GROUP)
    assert 0 < B - (groups - 1) * group <= group
    assert group - (B - (groups - 1) * group) < groups


def test_member_launch_source_groups_members():
    """The member launch is the grouped kernel: the group's slabs copied once, its block sums."""
    text = ft.SOURCE.read_text()
    assert 'extern "C" int frozen_tilt_members(' in text and "int group," in text
    assert "frozen_tilt_max_group" in text and "grid_sums<kThreads, kM>" in text
    assert "gridDim.y = member" not in text and "blockIdx.y * kM" in text


def test_problem_from_numpy_defaults_to_the_card():
    """Without ``device`` the JAX package's arrays go to the card: with no card this raises, as
    ``Minimizer`` does; ``device="cpu"`` keeps them on the CPU."""
    tables = {"vertex_valid": np.ones(3, bool), "tri_valid": np.ones(1, bool),
              "edge_valid": np.ones(3, bool), "body_valid": np.ones(1, bool)}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is not refused here")
    with pytest.raises(RuntimeError, match="cuda"):
        problem_from_numpy({}, tables, {})


def _grid_rows(nx: int, ny: int) -> np.ndarray:
    """Two triangles per cell of an nx x ny grid, in row order: tiles with interior vertices."""
    v = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    a, b, c, d = v[:-1, :-1].ravel(), v[:-1, 1:].ravel(), v[1:, :-1].ravel(), v[1:, 1:].ravel()
    return np.stack([np.stack([a, b, d], 1), np.stack([a, d, c], 1)], 1).reshape(-1, 3)


@pytest.mark.parametrize("mesh", ["grid_40x12", "grid_9x50", "random_301"])
def test_tile_sums_add_as_the_vertex_sum(mesh):
    """A member gradient launch sums each 128-triangle tile's interior vertices in the triangle
    pass and the rest through the scratch; in plain PyTorch (``tile_sums_reference``) that is the vertex
    sum's twin in bits, every interior vertex's corners lie in its tile, and the corner mask
    sends exactly the boundary vertices' corners."""
    if mesh == "random_301":
        rows = _member_inputs(1, np.float32)[2]
    else:
        nx, ny = (int(x) for x in mesh.split("_")[1].split("x"))
        rows = _grid_rows(nx, ny)
    rows_t = torch.as_tensor(rows)
    n_rows = int(rows.max()) + 2  # one vertex with no corner: a boundary row of zeros
    csr = corner_csr(rows_t, n_rows)
    ts = vs.tile_sums(csr)
    assert vs.tile_sums(csr) is ts
    tiles = -(-rows.shape[0] // vs.TILE)
    assert ts.tile_offsets.shape == (tiles + 2,) and int(ts.tile_offsets[-1]) == n_rows
    assert sorted(ts.tile_vertices.tolist()) == list(range(n_rows))
    interior = ts.interior.bool()
    assert not bool(interior[-1])
    if mesh != "random_301":
        assert int(interior.sum()) > 0
    sent = (ts.corner_mask[:, None].long() >> torch.arange(3)) & 1
    assert torch.equal(sent.bool(), ~interior[rows_t])
    rng = np.random.default_rng(5)
    for shape in ((rows.shape[0], 3), (rows.shape[0], 3, 3)):
        vals = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
        got = vs.tile_sums_reference(vals, csr)
        want = vs.reference(vals, csr)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
