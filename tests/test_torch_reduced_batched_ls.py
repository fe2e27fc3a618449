"""The reduced-energy line search's batched form: the same decisions and bits as the sequential one.

The JAX package's Armijo search takes its batched form on any backend but
the CPU, the reduced-energy search included: its candidates 1-9 relax the
leaflet tilts under one ``jax.vmap``.  The port runs them through a
member-batched leaflet relax (``tilt_relax.make_relax_leaflet_tilts_members``)
with kernel 1's member launch, energy and gradient, each member on its own
frozen inputs.  Held here, on the CPU (kernel 1 through its twin), with the
form forced through ``MEMBRANE_SOLVER_BATCHED_LS``:

- the member relax against B single relaxes, in bits and stats, at float64
  and float32, B = 1, 3 and 9, on seeded per-member heights and tilts
  relaxed beforehand to different depths, so members stop at different
  iterations: the full budget, convergence, ``rz_old == 0`` (the residual
  product floored to zero in both relaxes alike), line-search rejection
  (``tilt_axisym`` with the inner-coupled delta cap), the gd fallback with
  ``per_pass`` refreshes, and the GD solver;
- kernel 1's twin on the member axis, per-member g and payload and the
  gradient, against single calls in bits (and under ``torch.func.vmap``);
- the reduced search batched against sequential: equal accept flags and one
  sha256 of positions, tilts and energies over kozlov L1 ``minimize(3)``,
  and at L0 under both accept rules;
- the port's batched reduced search against the JAX package's batched
  reduced search on the same inputs, at 1e-12;
- the vertex-sharded block on the reduced lane under both forms, in bits.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch
from _torch_port_harness import FIXTURE, make_minimizer, seed_host

from membrane_solver_tpu_torch.device.state import MeshState
from membrane_solver_tpu_torch.runtime import jit_core
from membrane_solver_tpu_torch.runtime import tilt_relax as trelax

ENV = "MEMBRANE_SOLVER_BATCHED_LS"
FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")
GP = json.loads((FIXTURE.parent / "kozlov_L3_reduced_f64_jax.json").read_text())[
    "protocol"]["global_parameters"]
STEP = 0.15
ITERS = 10
JAX_RTOL = 1e-12
# how far each member's tilts are relaxed before the compared relax (single relax iterations)
DEPTHS = (0, 30, 0, 60, 15, 0, 45, 0, 90)
OPTIONS = {
    "default": ({}, 12.0, None),
    # members whose residual product falls under 50 take the rz_old == 0 exit
    "rz_zero": ({}, 0.0, 50.0),
    "rejection": ({"tilt_axisymmetric_about_thetaB_center": True,
                   "inner_coupled_update_mode": "rim_matched_radial_continuation_v1",
                   "benchmark_disk_radius": 1.0, "benchmark_lambda_value": 1.0}, 0.0, None),
    "gd_fallback_per_pass": ({"tilt_cg_rejection_fallback": "gd",
                              "tilt_projection_cadence": "per_pass"}, 12.0, None),
    "gd_solver": ({"tilt_solver": "gd", "tilt_projection_interval": 2}, 11.0, None),
}


_LANES: dict = {}


def _lane(dtype, options: dict):
    mn = make_minimizer(True, gp={**GP, **options}, dtype=dtype)
    seed_host(mn, 5)
    return mn.problem()


def _lane_members(dtype, name: str, members: int) -> tuple:
    """(problem, the first ``members`` member states) of option set ``name``, built once."""
    if (dtype, name) not in _LANES:
        p = _lane(dtype, OPTIONS[name][0])
        _LANES[dtype, name] = p, _member_states(p, len(DEPTHS) if name == "default" else 3)
    p, states = _LANES[dtype, name]
    return p, states[:members]


def _member_states(p, members: int) -> list:
    """Per member: seeded heights of its own scale, tilts relaxed to its depth in ``DEPTHS``."""
    rng = np.random.default_rng(1)
    dtype = p.state.positions.dtype
    movable = (~p.topo.fixed_mask)[:, None]
    single = trelax.make_relax_leaflet_tilts(p.spec)
    out = []
    for m in range(members):
        dz = torch.as_tensor(rng.standard_normal(tuple(p.state.positions.shape)) * 0.01
                             * (m % 3 + 1), dtype=dtype) * torch.tensor([0.0, 0.0, 1.0],
                                                                         dtype=dtype)
        st = dataclasses.replace(p.state,
                                 positions=torch.where(movable, p.state.positions + dz,
                                                       p.state.positions))
        if DEPTHS[m]:
            st = single(st, p.topo, p.params, DEPTHS[m], STEP, 0.0)[0]
        out.append(st)
    return out


def _stack(states: list) -> MeshState:
    return MeshState(*(torch.stack([getattr(s, f) for s in states]) for f in FIELDS))


def _floor_rz(monkeypatch, floor):
    if floor is None:
        return
    real = trelax._rz

    def floored(*args):
        rz = real(*args)
        return torch.where(rz < floor, 0.0, rz)

    monkeypatch.setattr(trelax, "_rz", floored)


# -------------------------------------------------- the member relax
def _check_member_relax(p, states, tol, floor, monkeypatch):
    _floor_rz(monkeypatch, floor)
    relax = trelax.make_relax_leaflet_tilts_members(p.spec)
    trelax.RELAX_RECORD = []
    try:
        out, stats = relax(_stack(states), p.topo, p.params, ITERS, STEP, tol)
        record = list(trelax.RELAX_RECORD)
    finally:
        trelax.RELAX_RECORD = None
    single = trelax.make_relax_leaflet_tilts(p.spec)
    singles = [single(st, p.topo, p.params, ITERS, STEP, tol) for st in states]
    for m, (s1, st1) in enumerate(singles):
        assert stats[m] == st1, m
        for f in FIELDS:
            assert torch.equal(getattr(out, f)[m], getattr(s1, f)), (m, f)
    assert record == [st1.accepted_steps for _s, st1 in singles]
    return [st1 for _s, st1 in singles]


@pytest.mark.parametrize("members", [1, 3, 9])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_member_relax_equals_single_relaxes(dtype, members, monkeypatch):
    _options, tol, floor = OPTIONS["default"]
    stats = _check_member_relax(*_lane_members(dtype, "default", members), tol, floor,
                                monkeypatch)
    if members == 9:
        # the members stop at different iterations: the budget, and convergence
        steps = {s.accepted_steps for s in stats}
        assert ITERS in steps and min(steps) < ITERS, steps


@pytest.mark.parametrize("name", ["rz_zero", "rejection", "gd_fallback_per_pass", "gd_solver"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_member_relax_options_equal_single_relaxes(dtype, name, monkeypatch):
    _options, tol, floor = OPTIONS[name]
    stats = _check_member_relax(*_lane_members(dtype, name, 3), tol, floor, monkeypatch)
    if name == "rejection":
        assert any(s.rejected for s in stats)
    if name == "rz_zero":
        assert min(s.accepted_steps for s in stats) < ITERS and not any(s.rejected for s in stats)


def test_member_relax_fused_energy_launches_the_member_entry(monkeypatch):
    """At float32 the member relax evaluates every member through the member entry point."""
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    calls = []
    real = ft.frozen_tilt_energy_members

    def spy(t_in, *args, **kw):
        calls.append((t_in.shape[0], t_in.requires_grad))
        return real(t_in, *args, **kw)

    monkeypatch.setattr(ft, "frozen_tilt_energy_members", spy)
    p, states = _lane_members(torch.float32, "default", 3)
    relax = trelax.make_relax_leaflet_tilts_members(p.spec)
    relax(_stack(states), p.topo, p.params, 2, STEP, 0.0)
    assert (3, True) in calls and (3, False) in calls


# ---------------------------------------------- kernel 1 on the member axis
def _kernel_inputs(members: int, seed: int):
    from membrane_solver_tpu_torch.device.state import corner_csr

    rng = np.random.default_rng(seed)
    N, T = 64, 101  # T not a multiple of 4: a member's g slab starts off a 16-byte boundary

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    rows = torch.as_tensor(np.stack([rng.choice(N, 3, replace=False) for _ in range(T)]))
    return (rows, corner_csr(rows, N), f32(members, T, 3, 3), f32(members, T, 20), f32(6),
            f32(members, N, 3), f32(members, N, 3))


@pytest.mark.parametrize("members", [1, 3, 9])
def test_frozen_tilt_member_gradient_equals_single_calls(members):
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    rows, csr, g, payload, k_vec, t_in, t_out = _kernel_inputs(members, members)
    a, b = t_in.clone().requires_grad_(True), t_out.clone().requires_grad_(True)
    before = dict(ft.LAUNCHES)
    E = ft.frozen_tilt_energy_members(a, b, rows, csr, g, payload, k_vec)
    gin, gout = torch.autograd.grad(E.sum(), (a, b))
    e_only = ft.frozen_tilt_energy_members(t_in, t_out, rows, csr, g, payload, k_vec)
    twin = ft.reference_members(t_in, t_out, rows, csr, g, payload, k_vec, grad=True)
    for m in range(members):
        x = t_in[m].clone().requires_grad_(True)
        y = t_out[m].clone().requires_grad_(True)
        e = ft.frozen_tilt_energy(x, y, rows, csr, g[m].clone(), payload[m].clone(), k_vec)
        hin, hout = torch.autograd.grad(e, (x, y))
        assert torch.equal(E[m], e) and torch.equal(e_only[m], e), m
        assert torch.equal(gin[m], hin) and torch.equal(gout[m], hout), m
        assert torch.equal(twin[0][m], e) and torch.equal(twin[1][m], hin), m
        assert torch.equal(twin[2][m], hout), m
    # shared g and payload (the relax backtrack's candidates)
    shared = ft.frozen_tilt_energy_members(t_in, t_out, rows, csr, g[0], payload[0], k_vec)
    assert torch.equal(shared, torch.stack([
        ft.frozen_tilt_energy(t_in[m].clone(), t_out[m].clone(), rows, csr, g[0], payload[0],
                              k_vec) for m in range(members)]))
    assert ft.LAUNCHES == before  # the CPU runs the twins: no launch is counted


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="the member launch needs a CUDA card")
def test_frozen_tilt_member_gradient_launch_equals_single_launches():
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    for members in (1, 3, 9):
        rows, csr, g, payload, k_vec, t_in, t_out = (
            x.cuda() if isinstance(x, torch.Tensor) else x
            for x in _kernel_inputs(members, members))
        from membrane_solver_tpu_torch.device.state import corner_csr

        csr = corner_csr(rows, t_in.shape[1])
        ws = ft.Workspace(rows.shape[0], t_in.device)
        e, gin, gout = ft.launch_members(t_in, t_out, rows, csr, g, payload, k_vec, ws, True)
        for m in range(members):
            e1, h1, h2 = ft.launch(t_in[m].clone(), t_out[m].clone(), rows, csr,
                                   g[m].clone(), payload[m].clone(), k_vec, ws, True)
            assert torch.equal(e[m:m + 1], e1) and torch.equal(gin[m], h1)
            assert torch.equal(gout[m], h2)


# ------------------------------------------------------------- whole runs
def _digest(state, energies) -> str:
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(getattr(state, f).detach().cpu().numpy().tobytes())
    h.update(np.asarray(energies, dtype=np.float64).tobytes())
    return h.hexdigest()


def _run(dtype, refines: int, options: dict, steps: int):
    mn = make_minimizer(True, gp={**GP, **options}, refines=refines, dtype=dtype)
    seed_host(mn, 2)
    flags, energies, trials = [], [], []
    for _ in range(steps):
        res = mn.minimize(1)
        flags.append(bool(res["step_success"]))
        energies.append(float(res["energy"]))
        trials.append(int(res["line_search_trials"]))
    return flags, _digest(mn.problem().state, energies), trials


@pytest.mark.parametrize("case", [
    (torch.float64, 1, {}, 3),
    (torch.float64, 0, {"step_size": 1.0, "line_search_reduced_accept_rule": "decrease_only"}, 2),
    (torch.float32, 0, {"step_size": 0.3}, 1),
], ids=["L1_f64_armijo", "L0_f64_decrease_only", "L0_f32_armijo"])
def test_reduced_search_both_forms(case, monkeypatch):
    dtype, refines, options, steps = case
    out = []
    for form in ("0", "1"):
        monkeypatch.setenv(ENV, form)
        out.append(_run(dtype, refines, options, steps))
    (f_seq, d_seq, t_seq), (f_bat, d_bat, t_bat) = out
    assert f_seq == f_bat and d_seq == d_bat
    # candidate 0 was rejected somewhere, so the member pass ran
    assert jit_core.LS_MAX_ITER in t_bat and t_seq != t_bat


def test_reduced_search_matches_jax_batched(monkeypatch):
    """One batched reduced search on the seeded L0 lane in both packages, on the same inputs."""
    import jax.numpy as jnp

    from membrane_solver_tpu.device.state import build_params as jbuild_params
    from membrane_solver_tpu.runtime import jit_core as jjit
    from membrane_solver_tpu.runtime import tilt_relax as jrelax

    monkeypatch.setenv(ENV, "1")  # JAX reads it when it traces
    gp = {**GP}
    tm = make_minimizer(True, gp=gp, dtype=torch.float64)
    jm = make_minimizer(False, gp=gp)
    for mn in (tm, jm):
        seed_host(mn, 2)
    p, jp = tm.problem(), jm.problem()
    n = p.state.positions.shape[0]
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(jp.state, f))[:n], getattr(p.state, f).numpy())
    jparams = jbuild_params(jm.mesh)
    E, grad = jit_core.make_energy_and_grad(p.spec)(p.state, p.topo, p.params)
    step, E0 = 0.3, float(E)
    movable = ~p.topo.fixed_mask
    reduced_n = int(jit_core.scalar_param(p.params, "line_search_reduced_tilt_inner_steps", 10.0))
    tol = jit_core.scalar_param(p.params, "tilt_tol", 0.0)

    # the port: the block's trial map (the lane enforces nothing in its line search), batched
    # with the member pass
    total = jit_core.make_energy_value(p.spec)
    relax = trelax.make_relax_leaflet_tilts(p.spec)
    relax_members = trelax.make_relax_leaflet_tilts_members(p.spec)

    def state_of_trial(x):
        st = dataclasses.replace(p.state, positions=x)
        st = relax(st, p.topo, p.params, reduced_n, GP["tilt_step_size"], tol)[0]
        return jit_core.project_all_tilts(st, p.topo)

    def states_of_trials(x):
        base = [getattr(p.state, f).expand((x.shape[0],) + tuple(x.shape[1:]))
                for f in FIELDS[1:]]
        st = relax_members(MeshState(x, *base), p.topo, p.params, reduced_n,
                           GP["tilt_step_size"], tol)[0]
        return torch.func.vmap(lambda s: jit_core.project_all_tilts(s, p.topo))(st)

    got = jit_core.armijo_line_search(
        lambda st: total(st, p.topo, p.params), p.state, grad, -grad, step, E0, movable, p.topo,
        state_of_trial, batched=True, states_of_trials=states_of_trials)
    assert got.trials == jit_core.LS_MAX_ITER  # candidate 0 rejected: the member pass ran

    # JAX: the same trial map
    jspec, jtopo, jstate = jp.spec, jp.topo, jp.state
    jrelax_fn = jrelax.make_relax_leaflet_tilts(jspec)
    jtotal = jjit.make_total_energy(jspec)

    def jstate_of_trial(x):
        st = dataclasses.replace(jstate, positions=x)
        st, _stats = jrelax_fn(st, jtopo, jparams, jnp.asarray(reduced_n, jnp.int32),
                               jnp.asarray(GP["tilt_step_size"]), jnp.asarray(tol))
        return jjit.project_all_tilts(st, jtopo)

    pad = np.asarray(jstate.positions)[n:] * 0.0
    jgrad = jnp.asarray(np.concatenate([grad.numpy(), pad]))
    want = jjit.armijo_line_search(
        lambda st: jtotal(st, jtopo, jparams), jstate, jgrad, -jgrad, jnp.asarray(step),
        jnp.asarray(E0), jtopo.vertex_valid & ~jtopo.fixed_mask, jtopo, jstate_of_trial)
    assert got.success == bool(want.success)
    for mine, theirs in ((got.new_step, want.new_step), (got.energy, want.energy)):
        assert abs(float(mine) - float(theirs)) <= JAX_RTOL * max(abs(float(theirs)), 1.0)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got.state, f).numpy(),
                                   np.asarray(getattr(want.state, f))[:n], rtol=JAX_RTOL,
                                   atol=JAX_RTOL, err_msg=f)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_tensor_parallel_reduced_block_both_forms(dtype, monkeypatch):
    """The vertex-sharded block (two CPU shards) reaches the reduced search and takes either
    form with the same bits (at float32 the relax's backtrack tails and the member relax score
    through the shards' own calls, whose float32 sums differ from one unsharded call's)."""
    from membrane_solver_tpu_torch.parallel import tensor as tp

    def run():
        mn = make_minimizer(True, gp={**GP, "step_size": 0.3}, dtype=dtype)
        seed_host(mn, 4)
        p = mn.problem()
        mesh = tp.tp_mesh(devices=["cpu"] * 2)
        state, topo = tp.shard_problem(p, mesh)
        opts = jit_core.MinimizeOptions(step_size_mode="fixed", enforce_in_line_search=True)
        ss = jit_core.fresh_stepper_state(state.positions.shape[0], dtype=dtype)
        block = tp.tp_minimize_block(p.spec, opts, mesh)
        state, _ss, stats = block(state, topo, p.params, ss, 2, 0.3, 0.3, 1e-12, 1e-10, 3, 0,
                                  10)
        return stats.accepted_steps, stats.trials, _digest(state, [stats.energy])

    out = []
    for form in ("0", "1"):
        monkeypatch.setenv(ENV, form)
        out.append(run())
    (acc_seq, trials_seq, d_seq), (acc_bat, trials_bat, d_bat) = out
    assert acc_seq == acc_bat and acc_seq > 0 and d_seq == d_bat
    assert trials_bat > trials_seq  # the member pass ran
