"""The port's vertex-sharded evaluation (``parallel/tensor``) against one-device results.

The JAX package's ``tests/test_tensor_parallel.py`` shards kozlov_1disk
(its defaults, at L0 and refined twice, L2) over 8 virtual CPU devices and
holds the sharded energy and gradient to the one-device ones: L0 energy
rel < 1e-12 and gradient abs < 1e-11, L2 energy rel < 1e-10 and gradient
rel < 1e-8 or abs < 1e-10, and one minimize-block step runs sharded.  The
port's counterpart of the virtual device list is an explicit list of torch
devices, here ``["cpu"] * 8``: eight triangle shards, each with its own
range, topology and corner CSR, the vertex sums reduced in shard order.

Held here, to those bars: the port's sharded energy and gradient against
the JAX package's one-device ``jit_core.make_energy_vg`` (the JAX test's
states) and against the port's own one-device call (those states and
seeded heights and tilts); two sharded runs in bits; one
``tp_minimize_block`` step against the one-device block (energy rel
1e-12, the same accept flag).  Each sharded kernel entry point (the
surface energy and its gradient, the curvature data and its backward, the
P1 divergence and its tilt backward, the frozen-tilt energy and its
gradients, the vertex sum) against the JAX package's function on the same
seeded inputs.  The launch counter under host threads.  The card runs the
same on ``[cuda:0] * 4`` and ``[cuda:0, cpu]`` (``chip_smoke.py`` phase
54).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import SMALL, assert_close, make_minimizer, seed_host, to_np

from membrane_solver_tpu.device import geo as jgeo
from membrane_solver_tpu.device import tilt_ops as jtops
from membrane_solver_tpu.pallas_kernels import frozen_tilt as jft
from membrane_solver_tpu.runtime import jit_core as jjit
from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.device import shard
from membrane_solver_tpu_torch.kernels import _launch
from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
from membrane_solver_tpu_torch.kernels import tri_kernels as tk
from membrane_solver_tpu_torch.kernels import vertex_sum as vs
from membrane_solver_tpu_torch.parallel import tensor as tp
from membrane_solver_tpu_torch.runtime import jit_core

MESH = ["cpu"] * 8
LEVELS = {"L0": 0, "L2": 2}
F64_RTOL = 1e-12
FT_ENERGY_RTOL = 1e-6  # the frozen-tilt kernel tests' float32 bounds
FT_GRAD_RTOL = 5e-6


def _bars_met(level, E, E_ref, g, g_ref) -> None:
    """The JAX test's bars at ``level``."""
    E, E_ref = float(E), float(E_ref)
    e_rel = abs(E - E_ref) / max(abs(E_ref), 1.0)
    diff = np.abs(to_np(g) - to_np(g_ref))
    if level == "L0":
        assert e_rel < 1e-12, e_rel
        assert float(np.max(diff)) < 1e-11, float(np.max(diff))
    else:
        assert e_rel < 1e-10, e_rel
        rel = float(np.max(diff / (np.abs(to_np(g_ref)) + 1e-11)))
        assert rel < 1e-8 or float(np.max(diff)) < 1e-10, (rel, float(np.max(diff)))


@pytest.fixture(scope="module", params=list(LEVELS))
def level_problems(request):
    """(level, JAX problem, port problem): kozlov_1disk with its defaults, refined as named."""
    refines = LEVELS[request.param]
    jm = make_minimizer(False, gp={}, refines=refines)
    tm = make_minimizer(True, gp={}, refines=refines, dtype=torch.float64)
    return request.param, jm.problem(), tm.problem()


def _port_problem(refines: int, seeded: bool):
    tm = make_minimizer(True, gp={}, refines=refines, dtype=torch.float64)
    if seeded:
        seed_host(tm, 5)
    return tm.problem()


def _tp(p, mesh=MESH):
    state, topo = tp.shard_problem(p, mesh)
    return tp.tp_energy_and_grad(p.spec, mesh)(state, topo, p.params), topo


def test_tp_energy_grad_matches_jax_one_device(level_problems):
    level, jp, p = level_problems
    n = p.n_vertices
    E_ref, g_ref = jjit.make_energy_vg(jp.spec)(jp.state.positions, jp.state, jp.topo, jp.params)
    (E, g), topo = _tp(p)
    assert len(topo.plan.shards) == 8
    assert g.devices == (torch.device("cpu"),) * 8
    _bars_met(level, E, E_ref, g.full(), np.asarray(g_ref)[:n])


@pytest.mark.parametrize("seeded", [False, True], ids=["flat", "seeded"])
@pytest.mark.parametrize("level", list(LEVELS))
def test_tp_energy_grad_matches_port_one_device(level, seeded):
    p = _port_problem(LEVELS[level], seeded)
    E_ref, g_ref = jit_core.make_energy_vg(p.spec)(p.state.positions, p.state, p.topo, p.params)
    (E, g), _topo = _tp(p)
    assert E.shape == () and g.full().shape == g_ref.shape
    _bars_met(level, E, E_ref, g.full(), g_ref)
    if seeded:
        # a real gradient: the bars are not met by round-off alone
        assert float(torch.max(torch.abs(g_ref))) > 1.0


def test_eight_shards_own_their_ranges_and_csr():
    p = _port_problem(0, True)
    _state, topo = tp.shard_problem(p, MESH)
    plan = topo.plan
    T, N = p.n_tris, p.n_vertices
    bounds = [(s.lo, s.hi) for s in plan.shards]
    assert bounds[0][0] == 0 and bounds[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo % shard.ALIGN == 0 and hi > lo for lo, hi in bounds)
    assert max(hi - lo for lo, hi in bounds) - min(hi - lo for lo, hi in bounds) <= 2 * shard.ALIGN
    csrs = [s.csr for s in plan.shards]
    assert len({id(c) for c in csrs}) == 8
    for s in plan.shards:
        assert torch.equal(s.topo.tri_rows, p.topo.tri_rows[s.lo:s.hi])
        assert s.topo.tri_rows.data_ptr() != p.topo.tri_rows.data_ptr()
        assert s.csr is s.topo.corner_csr() and s.csr.n_rows == N
        assert s.csr.slots.shape == (3 * (s.hi - s.lo),)
        assert torch.equal(s.topo.tri_valid, p.topo.tri_valid[s.lo:s.hi])
        assert torch.equal(s.topo.tri_surface_tension, p.topo.tri_surface_tension[s.lo:s.hi])
    owners = [(a, b) for _d, a, b in plan.owners]
    assert owners[0][0] == 0 and owners[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(owners, owners[1:]))
    # the full topology's CSR carries the plan; the shards' do not
    assert isinstance(topo.corner_csr(), shard.ShardedCSR) and topo.corner_csr().plan is plan
    assert all(shard.plan_of(c, p.state.positions, p.topo.tri_rows) is None for c in csrs)
    assert shard.plan_of(topo.corner_csr(), p.state.positions, p.topo.tri_rows) is plan
    with pytest.raises(ValueError, match=f"covers {T} triangles"):
        vs.vertex_sum(torch.ones((T - 1, 3)), topo.corner_csr())


def test_two_sharded_runs_give_the_same_bits():
    p = _port_problem(2, True)
    state, topo = tp.shard_problem(p, MESH)
    run = tp.tp_energy_and_grad(p.spec, MESH)
    (E1, g1), (E2, g2) = run(state, topo, p.params), run(state, topo, p.params)
    assert torch.equal(E1, E2) and torch.equal(g1.full(), g2.full())


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_tp_minimize_block_step_matches_one_device(n_shards):
    p = _port_problem(0, True)
    mesh = ["cpu"] * n_shards
    options = jit_core.MinimizeOptions(step_size_mode="fixed", enforce_in_line_search=True)

    def step(block, state, topo):
        ss = jit_core.fresh_stepper_state(p.n_vertices, "gradient_descent", dtype=torch.float64)
        return block(state, topo, p.params, ss, 1, 0.005, 0.005, 0.0, 1e-8, 10, 0, 5)

    want_state, _ss, want = step(jit_core.minimize_block(p.spec, options), p.state, p.topo)
    state, topo = tp.shard_problem(p, mesh)
    got_state, _ss, got = step(tp.tp_minimize_block(p.spec, options, mesh), state, topo)
    assert abs(got.energy - want.energy) <= 1e-12 * abs(want.energy)
    assert got.step_success == want.step_success and got.iterations == want.iterations
    assert torch.isfinite(got_state.positions).all()
    assert_close(got_state.positions, want_state.positions, 1e-12, "positions")


def test_unsharded_topology_and_other_mesh_raise():
    p = _port_problem(0, False)
    with pytest.raises(ValueError, match="not sharded"):
        tp.tp_energy_and_grad(p.spec, MESH)(p.state, p.topo, p.params)
    state, topo = tp.shard_problem(p, ["cpu"] * 2)
    with pytest.raises(ValueError, match="not sharded over this mesh"):
        tp.tp_energy_and_grad(p.spec, ["cpu"] * 3)(state, topo, p.params)
    with pytest.raises(ValueError, match="do not fill"):
        tp.shard_problem(p, ["cpu"] * (p.n_tris // shard.ALIGN + 1))


def test_tp_mesh_forms():
    assert tp.tp_mesh(devices=["cpu"] * 3) == (torch.device("cpu"),) * 3
    assert tp.tp_mesh(2, devices=["cpu", "cpu:0", "cpu"]) == (torch.device("cpu"),) * 2
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="visible"):
            tp.tp_mesh()


# ----------------------------------------------------------------------
# each sharded entry point against the JAX package's function
# ----------------------------------------------------------------------
@pytest.fixture(scope="module", params=[3, 8], ids=["3_shards", "8_shards"])
def sharded_arrays(request):
    """(sharded topology, positions, valid, tilts, tension) on kozlov L1 (SMALL), float64:
    positions perturbed by a seed, some triangles masked, mixed tensions."""
    mn = make_minimizer(True, kw=SMALL, refines=1, dtype=torch.float64)
    p = mn.problem()
    rng = np.random.default_rng(23)
    pos = p.state.positions.numpy() + 0.01 * rng.standard_normal((p.n_vertices, 3))
    valid = p.topo.tri_valid.numpy().copy()
    valid[::17] = False
    tilts = 0.3 * rng.standard_normal(pos.shape)
    tension = rng.uniform(0.5, 2.0, p.n_tris)
    tension[::5] = 0.0
    _state, topo = tp.shard_problem(p, ["cpu"] * request.param)
    return topo, pos, valid, tilts, tension


def _j(topo):
    return jnp.asarray(topo.tri_rows.numpy(), jnp.int32)


def test_sharded_surface_energy_matches_jax(sharded_arrays):
    topo, pos, valid, _t, tension = sharded_arrays
    j_rows, j_valid, gamma = _j(topo), jnp.asarray(valid), jnp.asarray(tension)

    def jax_energy(p):
        return jnp.sum(jnp.where(j_valid, gamma, 0.0)
                       * jgeo.triangle_geometry(p, j_rows, j_valid).area)

    want_e, want_g = jax.value_and_grad(jax_energy)(jnp.asarray(pos))
    v, ten, csr = torch.as_tensor(valid), torch.as_tensor(tension), topo.corner_csr()
    x = torch.as_tensor(pos).requires_grad_(True)
    e = tk.surface_energy(x, topo.tri_rows, v, ten, csr)
    (grad,) = torch.autograd.grad(e, (x,))
    assert e.shape == ()
    assert_close(e.detach(), np.asarray(want_e), F64_RTOL, "surface energy")
    assert_close(grad, want_g, F64_RTOL, "surface gradient")
    e2, g2 = tk.surface_energy_and_gradient(torch.as_tensor(pos), topo.tri_rows, v, ten, csr)
    assert_close(e2, np.asarray(want_e), F64_RTOL, "area-call energy")
    assert_close(g2, want_g, F64_RTOL, "area-call gradient")
    assert torch.equal(tk.surface_energy(torch.as_tensor(pos), topo.tri_rows, v, ten, csr), e2)


def test_sharded_curvature_data_matches_jax_and_its_vjp(sharded_arrays):
    topo, pos, valid, _t, _ten = sharded_arrays
    nv, T = pos.shape[0], topo.tri_rows.shape[0]
    rng = np.random.default_rng(29)
    cts = (rng.standard_normal((nv, 3)), rng.standard_normal(nv), rng.standard_normal((T, 3)),
           rng.standard_normal((T, 3)))
    j_rows, j_valid = _j(topo), jnp.asarray(valid)

    def jax_data(p):
        c = jgeo.curvature_data(p, j_rows, j_valid, nv)
        return c.k_vecs, c.vertex_areas, c.weights, c.corner_areas

    want, vjp = jax.vjp(jax_data, jnp.asarray(pos))
    (want_grad,) = vjp(tuple(map(jnp.asarray, cts)))
    x = torch.as_tensor(pos).requires_grad_(True)
    cd = tk.curvature_data(x, topo.tri_rows, torch.as_tensor(valid), topo.corner_csr())
    got = (cd.k_vecs, cd.vertex_areas, cd.weights, cd.corner_areas)
    for g, w, name in zip(got, want, ("k_vecs", "vertex_areas", "weights", "corner_areas")):
        assert_close(g, w, F64_RTOL, name, atol_scale=1.0)
    (grad,) = torch.autograd.grad(sum(torch.sum(g * torch.as_tensor(c)) for g, c in zip(got, cts)),
                                  (x,))
    assert_close(grad, want_grad, F64_RTOL, "curvature_data vjp", atol_scale=1.0)


def test_sharded_p1_divergence_matches_jax_and_its_tilt_vjp(sharded_arrays):
    topo, pos, valid, tilts, _ten = sharded_arrays
    j_rows, j_valid = _j(topo), jnp.asarray(valid)
    want, vjp = jax.vjp(lambda t: jtops.p1_triangle_divergence(jnp.asarray(pos), t, j_rows,
                                                               j_valid), jnp.asarray(tilts))
    ct = np.random.default_rng(41).standard_normal(topo.tri_rows.shape[0])
    (want_dt,) = vjp((jnp.asarray(ct), jnp.zeros_like(want[1]), jnp.zeros_like(want[2])))
    a = torch.as_tensor(tilts).requires_grad_(True)
    got = tk.p1_triangle_divergence(torch.as_tensor(pos), a, topo.tri_rows,
                                    torch.as_tensor(valid), topo.corner_csr())
    for g, w, name in zip(got, want, ("div", "area", "g")):
        assert_close(g.detach(), w, F64_RTOL, name, atol_scale=1.0)
    (dt,) = torch.autograd.grad(got[0], (a,), (torch.as_tensor(ct),))
    assert_close(dt, want_dt, F64_RTOL, "tilt vjp", atol_scale=1.0)


def test_sharded_vertex_sum_matches_jax_scatter_and_gathers_back(sharded_arrays):
    topo, pos, _valid, _t, _ten = sharded_arrays
    nv, T = pos.shape[0], topo.tri_rows.shape[0]
    rng = np.random.default_rng(43)
    vals = rng.standard_normal((3, T, 3))
    want = jgeo.scatter_add_rows(*map(jnp.asarray, vals), _j(topo), nv)
    parts = [torch.as_tensor(v).requires_grad_(True) for v in vals]
    got = tgeo.scatter_add_rows(*parts, topo.corner_csr())
    assert_close(got, want, F64_RTOL, "scatter_add_rows", atol_scale=1.0)
    w = torch.as_tensor(rng.standard_normal((nv, 3)))
    grads = torch.autograd.grad(torch.sum(w * got), parts)
    rows = topo.tri_rows
    for c, g in enumerate(grads):
        assert torch.equal(g, w[rows[:, c]])
    ones = vs.vertex_sum(torch.ones((T, 3)), topo.corner_csr())
    assert torch.equal(ones, torch.bincount(rows.reshape(-1), minlength=nv).to(ones.dtype))


def test_sharded_frozen_tilt_energy_matches_jax_oracle(sharded_arrays):
    """float32, the kernel's dtype: the energy and both vertex gradients against the JAX
    package's oracle on gathered corners and ``jax.grad``, to the kernel tests' bounds."""
    topo, _pos, _valid, _t, _ten = sharded_arrays
    nv, T = topo.vertex_valid.shape[0], topo.tri_rows.shape[0]
    rng = np.random.default_rng(47)
    t_in, t_out = (rng.standard_normal((nv, 3)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((T, 3, 3)).astype(np.float32)
    pay = np.abs(rng.standard_normal((T, 20))).astype(np.float32)
    k = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    j_rows = _j(topo)
    jg, jpay, jk = map(jnp.asarray, (g, pay, k))

    def jax_energy(a, b):
        return jft.reference_energy(a[j_rows], b[j_rows], jg, jpay, jk)

    want_e = float(jax_energy(jnp.asarray(t_in), jnp.asarray(t_out)))
    want_g = jax.grad(jax_energy, argnums=(0, 1))(jnp.asarray(t_in), jnp.asarray(t_out))
    a, b = (torch.as_tensor(x).requires_grad_(True) for x in (t_in, t_out))
    e = ft.frozen_tilt_energy(a, b, topo.tri_rows, topo.corner_csr(), torch.as_tensor(g),
                              torch.as_tensor(pay), torch.as_tensor(k))
    grads = torch.autograd.grad(e, (a, b))
    assert float(e.detach()) == pytest.approx(want_e, rel=FT_ENERGY_RTOL)
    for got, want in zip(grads, want_g):
        assert_close(got, want, FT_GRAD_RTOL, "frozen-tilt gradient")
    e_only = ft.frozen_tilt_energy(torch.as_tensor(t_in), torch.as_tensor(t_out), topo.tri_rows,
                                   topo.corner_csr(), torch.as_tensor(g), torch.as_tensor(pay),
                                   torch.as_tensor(k))
    assert torch.equal(e_only, e.detach())


def test_vmap_takes_the_unsharded_path(sharded_arrays):
    """Under ``torch.func.vmap`` the plan steps aside: each member the full CSR's sum."""
    topo, pos, _valid, _t, _ten = sharded_arrays
    T = topo.tri_rows.shape[0]
    vals = torch.as_tensor(np.random.default_rng(53).standard_normal((2, T, 3, 3)))
    csr = topo.corner_csr()
    plain = dataclasses.replace(csr, plan=None)
    got = torch.func.vmap(lambda c: vs.vertex_sum(c, csr))(vals)
    for m in range(2):
        assert torch.equal(got[m], vs.vertex_sum(vals[m], plain))


def test_launch_counts_add_up_under_threads():
    """``kernels/_launch.count`` from more host threads than cores at once: every launch
    counted, in the module's counters, the card's counts and a CSR's tally."""
    counters = {"k": 0}
    like = torch.zeros(1)
    csr = tk.CornerCSR(offsets=torch.zeros(2, dtype=torch.int32),
                       slots=torch.zeros(3, dtype=torch.int32),
                       rows=torch.zeros((1, 3), dtype=torch.int64))
    tally: dict = {}
    _launch.keep_tally(csr, tally)
    before = _launch.launches_on(-1).get("test.k", 0)
    n, per = 4 * (os.cpu_count() or 4), 2000

    def work():
        for _ in range(per):
            _launch.count(counters, "test", "k", like, csr)

    threads = [threading.Thread(target=work) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter allows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counters["k"] == n * per
    assert tally == {"test.k": n * per}
    assert _launch.launches_on(-1)["test.k"] - before == n * per
