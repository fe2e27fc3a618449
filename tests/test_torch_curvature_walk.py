"""The order the curvature whole call's vertex-row kernel follows, on the CPU.

``tri_curvature_data`` runs a lane group per row of the topology's corner
CSR: each lane takes one slot (t, c), recomputes triangle t and writes
``cot[t, c]`` and ``va[t, c]``, and the group adds corner c's vector and
area into its row in slot order from +0.  Two facts make that the bits of
the per-triangle kernel followed by the vertex sum, and these tests pin
them on the twins:

- every slot 0 .. 3T - 1 is listed exactly once (so each ``cot`` and
  ``va`` entry has one writer, and every corner reaches its vertex): for
  every meshgen builder the lane tests run, and for the cube after ``r``
  and ``u`` (``Topology.corner_csr``);
- ``curvature_data_reference`` and ``curvature_data_vjp_reference`` sum the
  twin's per-corner values as a plain loop over each row's slots from
  +0.0 does, in value and sign bits, at float32 and float64 (masked
  triangles give -0.0 corner values, which the sum from +0.0 drops).

On a card only (marker ``cuda``): the kernel against the twin and, in
bits, against the per-triangle kernel followed by the vertex sum, for one
call and for B = 1, 3 and 8 members.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port_harness  # noqa: F401  (its torch thread count for the xdist workers)
from _torch_port_harness import SMALL, make_minimizer

from membrane_solver_tpu_torch import Minimizer, parse_geometry
from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.device.state import corner_csr
from membrane_solver_tpu_torch.kernels import tri_kernels as tk
from membrane_solver_tpu_torch.kernels import vertex_sum as vs
from membrane_solver_tpu_torch.meshgen import build
from membrane_solver_tpu_torch.runtime.equiangulation import equiangulate_mesh
from membrane_solver_tpu_torch.runtime.refinement import refine_triangle_mesh

# the builders tests/test_torch_lanes.py runs, and the kozlov lane's
BUILDERS = ["dented_cube", "sphere", "two_disks_sphere", "torus", "flat_disk", "square_sheet",
            "square_to_circle", "rect_tilt_source", "catenoid", "spherical_cap", "kozlov_1disk",
            "cube"]


def _topology(mesh):
    return Minimizer(mesh, device="cpu", dtype=torch.float64, quiet=True).problem().topo


def _cube_r_u():
    """The cube's mesh after one ``r`` and one ``u``, as its recipe runs them."""
    mesh = parse_geometry(build("cube"))
    return equiangulate_mesh(refine_triangle_mesh(mesh))


def _assert_slots_are_a_permutation(topo):
    T = topo.tri_rows.shape[0]
    csr = topo.corner_csr()
    slots = csr.slots.long()
    assert slots.shape == (3 * T,)
    assert torch.equal(torch.sort(slots).values, torch.arange(3 * T))
    # each row lists the corners at that row, and the offsets cover every slot once
    assert int(csr.offsets[0]) == 0 and int(csr.offsets[-1]) == 3 * T
    degree = (csr.offsets[1:] - csr.offsets[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(csr.n_rows), degree)
    assert torch.equal(topo.tri_rows.reshape(-1)[slots], rows)


@pytest.mark.parametrize("name", BUILDERS)
def test_corner_csr_lists_every_slot_once(name):
    _assert_slots_are_a_permutation(_topology(parse_geometry(build(name))))


def test_corner_csr_lists_every_slot_once_after_r_and_u():
    _assert_slots_are_a_permutation(_topology(_cube_r_u()))


def _plain_row_sums(corner_values, csr, dtype):
    """(N, *w) rows: for each row, +0.0 plus its slots' values one by one, in numpy."""
    flat = corner_values.detach().reshape(3 * corner_values.shape[0], -1).numpy()
    offsets, slots = csr.offsets.numpy(), csr.slots.numpy()
    out = np.zeros((csr.n_rows, flat.shape[1]), dtype=dtype)
    for v in range(csr.n_rows):
        acc = np.zeros(flat.shape[1], dtype=dtype)  # +0.0
        for j in range(offsets[v], offsets[v + 1]):
            acc = acc + flat[slots[j]]
        out[v] = acc
    return torch.from_numpy(out.reshape((csr.n_rows,) + tuple(corner_values.shape[2:])))


def _same_bits(got, want):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.view(ints[got.dtype]), want.view(ints[want.dtype])))


def _case_arrays(case):
    """(positions, tri_rows, tri_valid) float64 numpy, every 7th triangle masked."""
    rng = np.random.default_rng(17)
    if case == "kozlov_L0":
        p = make_minimizer(True, kw=SMALL, dtype=torch.float64).problem()
        pos, rows = p.state.positions.numpy(), p.topo.tri_rows.numpy()
        pos = pos + 0.01 * rng.standard_normal(pos.shape)
    else:
        p = Minimizer(_cube_r_u(), device="cpu", dtype=torch.float64, quiet=True).problem()
        pos, rows = p.state.positions.numpy(), p.topo.tri_rows.numpy()  # right angles: ties
    valid = np.ones(rows.shape[0], dtype=bool)
    valid[::7] = False
    return pos, rows, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["kozlov_L0", "cube_r_u"])
def test_twin_sums_are_the_plain_slot_loop_from_plus_zero(case, dtype):
    pos, rows_np, valid_np = _case_arrays(case)
    p = torch.as_tensor(pos, dtype=dtype)
    rows, valid = torch.as_tensor(rows_np), torch.as_tensor(valid_np)
    csr = corner_csr(rows, p.shape[0])
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    corners = [p[rows[:, i]] for i in range(3)]
    cot, k0, k1, k2, va, _area = tgeo.curvature_corners(*corners, valid)
    k = torch.stack([k0, k1, k2], dim=1)
    assert bool(torch.any(torch.signbit(k[~valid]) & (k[~valid] == 0)))  # -0.0 corners present

    got_cot, got_va, k_vecs, areas = tk.curvature_data_reference(p, rows, valid, csr)
    assert _same_bits(got_cot, cot) and _same_bits(got_va, va)
    assert _same_bits(k_vecs, _plain_row_sums(k, csr, np_dtype))
    assert _same_bits(areas, _plain_row_sums(va, csr, np_dtype))

    rng = np.random.default_rng(29)
    nv, T = p.shape[0], rows.shape[0]
    g_kvecs, g_varea = (torch.as_tensor(rng.standard_normal(s), dtype=dtype)
                        for s in ((nv, 3), (nv,)))
    dpos = tk.curvature_data_vjp_reference(p, rows, valid, csr, g_kvecs, g_varea, None, None)
    zeros = p.new_zeros((T, 3))
    dc = tk.curvature_corners_vjp(p, rows, valid, zeros, g_kvecs[rows], g_varea[rows],
                                  zeros[:, 0])
    assert _same_bits(dpos, _plain_row_sums(dc, csr, np_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_curvature_data_matches_twin_and_two_launch_bits(dtype):
    """Card only: the whole calls against the twin, and in bits against the per-triangle
    kernel followed by the vertex sum, single and at B = 1, 3 and 8 members."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    pos, rows_np, valid_np = _case_arrays("kozlov_L0")
    p = torch.as_tensor(pos, dtype=dtype, device="cuda")
    rows = torch.as_tensor(rows_np, device="cuda")
    valid = torch.as_tensor(valid_np, device="cuda")
    csr = corner_csr(rows, p.shape[0])
    nv, T = p.shape[0], rows.shape[0]
    tol = 1e-12 if dtype == torch.float64 else 5e-5

    got = tk.launch_curvature_data(p, rows, valid, csr)
    want = tk.curvature_data_reference(p, rows, valid, csr)
    for a, b in zip(got, want):
        assert float(torch.max(torch.abs(a - b))) <= tol * max(float(torch.max(torch.abs(b))), 1.0)
    cot1, k1, va1, _area = tk.launch_curvature(p, rows, valid)
    assert _same_bits(got[0], cot1) and _same_bits(got[1], va1)
    assert _same_bits(got[2], vs.launch(k1, csr)) and _same_bits(got[3], vs.launch(va1, csr))

    gen = torch.Generator(device="cuda").manual_seed(3)
    for B in (1, 3, 8):
        ps = torch.stack([p * (1 + 0.001 * m) for m in range(B)]).contiguous()
        ups = [torch.randn((B,) + s, dtype=dtype, device="cuda", generator=gen)
               for s in ((nv, 3), (nv,), (T, 3), (T, 3))]
        outs = tk.launch_curvature_data_members(ps, rows, valid, csr)
        dpos = tk.launch_curvature_data_bwd_members(ps, rows, valid, csr, *ups)
        for m in range(B):
            single = tk.launch_curvature_data(ps[m].contiguous(), rows, valid, csr)
            assert all(_same_bits(a[m], b) for a, b in zip(outs, single)), (B, m)
            one = tk.launch_curvature_data_bwd(ps[m].contiguous(), rows, valid, csr,
                                               *(u[m].contiguous() for u in ups))
            assert _same_bits(dpos[m], one), (B, m)
            want_bwd = tk.curvature_data_vjp_reference(ps[m], rows, valid, csr,
                                                       *(u[m] for u in ups))
            assert float(torch.max(torch.abs(one - want_bwd))) <= (
                (1e-11 if dtype == torch.float64 else 5e-5) * float(torch.max(torch.abs(want_bwd))))
    torch.cuda.synchronize()
