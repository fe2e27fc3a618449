"""The batched line search (``utils/tuning``): the same decisions and bits as the sequential one.

The JAX package evaluates a backtracking search's candidates as one
vmapped batch on any backend but the CPU
(``membrane_solver_tpu/utils/tuning.py``): the Armijo search, the leaflet
relax's and the single-field relax's 12-halving backtracks.  The port does
the same for state on the card.  Held here, on the CPU with the form forced
through ``MEMBRANE_SOLVER_BATCHED_LS``:

- the switch: JAX's override spellings and the device rule;
- ``jit_core.armijo_line_search`` batched against sequential, equal in bits
  (success, next step, energy, positions and tilts), on JAX's quadratic at
  steps 0.05, 0.7, 5 and 50, past the step floor, along a non-descent
  direction, through a normal-rotation rejection, and on the kozlov lane's
  own trial (enforcement, tilt enforcement, tangent projection) at L0 and
  L1; and against JAX's batched form on the same inputs at 1e-12;
- both relaxes (kozlov L1 leaflet at float64 and float32, ``rect_tilt_source``
  single field), batched against sequential in bits;
- the frozen-tilt entry point under ``torch.func.vmap`` over 1, 3 and 11
  members against its single calls, in bits, and with a mapped tilt
  gradient (mapped g and payload) against single calls;
- kozlov L1 ``minimize(3)``, the vesicle at L2 through ``g3`` and the
  vertex-sharded block on two CPU shards under both forms: equal accept
  flags and one sha256 of positions, tilts and energies.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from membrane_solver_tpu_torch.device.reduce import member_sum
from membrane_solver_tpu_torch.runtime import jit_core
from membrane_solver_tpu_torch.utils import tuning
from tests._torch_port_harness import (
    BENCH_GP,
    make_minimizer,
    make_vesicle_minimizer,
    recipe_context,
    seed_host,
)

ENV = "MEMBRANE_SOLVER_BATCHED_LS"
FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")
JAX_RTOL = 1e-12


# ----------------------------------------------------------------- the switch
def test_env_override(monkeypatch):
    for value, want in (("0", False), ("false", False), ("no", False), ("1", True),
                        ("true", True), ("yes", True)):
        monkeypatch.setenv(ENV, value)
        assert tuning.batched_line_search("cpu") is want, value
        assert tuning.batched_line_search("cuda") is want, value


def test_tracks_device(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert tuning.batched_line_search("cpu") is False
    assert tuning.batched_line_search(torch.device("cpu")) is False
    assert tuning.batched_line_search("cuda") is True
    assert tuning.batched_line_search(torch.device("cuda", 1)) is True


# ------------------------------------------------------ the Armijo search
@pytest.fixture(scope="module")
def cube():
    """The port's and the JAX package's compiled cube (meshes/cube.json), no recipe."""
    from membrane_solver_tpu import Minimizer as JaxMinimizer
    from membrane_solver_tpu import load_data as jax_load
    from membrane_solver_tpu import parse_geometry as jax_parse
    from membrane_solver_tpu_torch import Minimizer, load_data, parse_geometry

    mesh = parse_geometry(load_data("meshes/cube.json"))
    mesh.instructions = []
    jmesh = jax_parse(jax_load("meshes/cube.json"))
    jmesh.instructions = []
    return (Minimizer(mesh, quiet=True, device="cpu", dtype=torch.float64).problem(),
            JaxMinimizer(jmesh, quiet=True).problem())


def _cases():
    """name -> (step, direction kind, energy kind): JAX's four steps, then the edge cases."""
    return {
        "step_0.05": (0.05, "descent", "quadratic"),
        "step_0.7": (0.7, "descent", "quadratic"),
        "step_5": (5.0, "descent", "quadratic"),
        "step_50": (50.0, "descent", "quadratic"),
        # the chain crosses the 1e-8 floor at candidate 4; only candidate 4+ would pass
        "past_floor": (3e-8, "descent", "steep"),
        "non_descent": (0.7, "uphill", "quadratic"),
        # large steps of a rough direction rotate the cube's normals past 0.5 rad
        "normal_rotation": (2.0, "rough", "quadratic"),
    }


def _inputs(positions, valid, fixed, kind: str, energy: str, xp):
    """(energy_of_state, grad, direction, energy0 offset) of one case, on ``xp``'s arrays."""
    rng = np.random.default_rng(7)
    mask = np.asarray(valid)[:, None]
    g = np.where(mask, -0.5, 0.0) * np.ones((len(mask), 3))
    if kind == "rough":
        d = np.where(mask, rng.standard_normal((len(mask), 3)), 0.0)
        g = -d
    elif kind == "uphill":
        d = g.copy()
    else:
        d = -g
    target = np.where(mask, np.asarray(positions) + (0.06 * d if kind == "rough" else 0.25),
                      np.asarray(positions))
    return g, d, target


def _port_search(p, case, batched: bool):
    step, kind, energy = case
    state, topo = p.state, p.topo
    g, d, target = _inputs(state.positions, topo.vertex_valid, topo.fixed_mask, kind, energy, np)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    g, d, target = as_t(g), as_t(d), as_t(target)
    base = state.positions
    valid = topo.vertex_valid[:, None]

    if energy == "steep":
        def energy_of_state(st):
            return 1.0 + 2e9 * torch.max(torch.abs(st.positions - base))
        e0 = 10.0
    else:
        def energy_of_state(st):
            r = torch.where(valid, st.positions - target, 0.0)
            return member_sum(r * r)
        e0 = float(energy_of_state(state))
    movable = topo.vertex_valid & ~topo.fixed_mask
    return jit_core.armijo_line_search(
        energy_of_state, state, g, d, step, e0, movable, topo,
        lambda trial: dataclasses.replace(state, positions=trial), batched=batched)


def _assert_same(a, b, what):
    assert a.success == b.success, what
    assert a.new_step == b.new_step and type(a.new_step) is type(b.new_step), what
    assert a.energy == b.energy, what
    for f in FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), (what, f)


@pytest.mark.parametrize("name", list(_cases()))
def test_armijo_batched_equals_sequential(cube, name):
    p, _jp = cube
    case = _cases()[name]
    seq = _port_search(p, case, False)
    bat = _port_search(p, case, True)
    _assert_same(seq, bat, name)
    if name == "past_floor":
        assert not bat.success
    if name == "non_descent":
        assert not bat.success and bat.trials == 0 and bat.new_step == np.float64(0.7)
    if name in ("step_5", "step_50", "normal_rotation"):
        assert bat.trials == jit_core.LS_MAX_ITER  # candidate 0 rejected: the map ran


def test_normal_rotation_case_rejects_candidate_0(cube):
    """The rough case's first candidate fails the rotation check, so both forms skip it."""
    from membrane_solver_tpu_torch.device import geo as dgeo

    p, _jp = cube
    step, kind, energy = _cases()["normal_rotation"]
    _g, d, _t = _inputs(p.state.positions, p.topo.vertex_valid, p.topo.fixed_mask, kind,
                        energy, np)
    trial = p.state.positions + step * torch.as_tensor(d)
    assert not bool(dgeo.check_normal_rotation(p.state.positions, trial, p.topo.tri_rows,
                                               p.topo.tri_valid, jit_core.NORMAL_LIMIT_RADIANS))
    assert _port_search(p, _cases()["normal_rotation"], True).success


@pytest.mark.parametrize("name", ["step_0.05", "step_0.7", "step_5", "step_50", "past_floor",
                                  "non_descent", "normal_rotation"])
def test_armijo_batched_matches_jax_batched(cube, name, monkeypatch):
    import jax.numpy as jnp

    from membrane_solver_tpu.runtime import jit_core as jjit

    p, jp = cube
    step, kind, energy = _cases()[name]
    got = _port_search(p, _cases()[name], True)
    jstate, jtopo = jp.state, jp.topo
    # the JAX problem pads its rows past the port's n (invalid rows); the inputs are the port's
    n = p.state.positions.shape[0]
    assert np.array_equal(np.asarray(jstate.positions)[:n], p.state.positions.numpy())
    assert not np.asarray(jtopo.vertex_valid)[n:].any()
    pad = lambda a: jnp.asarray(np.concatenate(  # noqa: E731
        [a, np.asarray(jstate.positions)[n:] * 0.0]))
    g, d, target = _inputs(p.state.positions, p.topo.vertex_valid, p.topo.fixed_mask, kind,
                           energy, np)
    g, d = pad(g), pad(d)
    target = jnp.asarray(np.concatenate([target, np.asarray(jstate.positions)[n:]]))
    valid = jtopo.vertex_valid[:, None]
    base = jstate.positions
    if energy == "steep":
        def energy_of_state(st):
            return 1.0 + 2e9 * jnp.max(jnp.abs(st.positions - base))
        e0 = jnp.asarray(10.0)
    else:
        def energy_of_state(st):
            r = jnp.where(valid, st.positions - target, 0.0)
            return jnp.sum(r * r)
        e0 = energy_of_state(jstate)
    monkeypatch.setenv(ENV, "1")
    want = jjit.armijo_line_search(
        energy_of_state, jstate, g, d, jnp.asarray(step), e0,
        jtopo.vertex_valid & ~jtopo.fixed_mask, jtopo,
        lambda trial: dataclasses.replace(jstate, positions=trial))
    assert got.success == bool(want.success), name
    for mine, theirs in ((got.new_step, want.new_step), (got.energy, want.energy)):
        assert abs(float(mine) - float(theirs)) <= JAX_RTOL * max(abs(float(theirs)), 1.0), name
    np.testing.assert_allclose(got.state.positions.numpy(),
                               np.asarray(want.state.positions)[:n], rtol=JAX_RTOL, atol=JAX_RTOL)


@pytest.fixture(scope="module", params=[0, 1], ids=["L0", "L1"])
def kozlov_trial(request):
    """The kozlov lane's line-search inputs (seeded heights and tilts): problem, the block's
    trial map (enforcement, tilt enforcement, tangent projection), energy, gradient."""
    from membrane_solver_tpu_torch.runtime import tilt_relax

    mn = make_minimizer(True, refines=request.param, dtype=torch.float64)
    seed_host(mn, 5)
    p = mn.problem()
    spec, topo, params = p.spec, p.topo, p.params
    enforce = jit_core.make_constraint_enforcer(spec)
    tilt_enforce = tilt_relax.make_tilt_enforcer(spec)
    total = jit_core.make_energy_value(spec)
    E, grad = jit_core.make_energy_and_grad(spec)(p.state, topo, params)

    def state_of_trial(x):
        st = dataclasses.replace(p.state, positions=x)
        st = tilt_enforce(enforce(st, topo, params, context="minimize"), topo, params)
        return jit_core.project_all_tilts(st, topo)

    return p, state_of_trial, (lambda st: total(st, topo, params)), float(E), grad


@pytest.mark.parametrize("step", [0.005, 0.5, 5.0])
def test_armijo_kozlov_trial(kozlov_trial, step):
    from membrane_solver_tpu_torch.parallel.member_block import prime_ordered_levels

    p, state_of_trial, energy, E, grad = kozlov_trial
    prime_ordered_levels(p.spec, p.topo)
    movable = ~p.topo.fixed_mask
    out = [jit_core.armijo_line_search(energy, p.state, grad, -grad, step, E, movable, p.topo,
                                       state_of_trial, batched=b) for b in (False, True)]
    _assert_same(*out, step)


# ------------------------------------------------------------- the relaxes
def _relax_pair(make, state, topo, params, n, step, tol, monkeypatch):
    from membrane_solver_tpu_torch.runtime import tilt_relax

    out = []
    for form in ("0", "1"):
        monkeypatch.setenv(ENV, form)
        tilt_relax.RELAX_RECORD = []
        try:
            out.append(make(state, topo, params, n, step, tol))
        finally:
            tilt_relax.RELAX_RECORD = None
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_leaflet_relax_batched_equals_sequential(dtype, monkeypatch):
    from membrane_solver_tpu_torch.runtime import tilt_relax

    mn = make_minimizer(True, refines=1, dtype=dtype)
    seed_host(mn, 11)
    p = mn.problem()
    relax = tilt_relax.make_relax_leaflet_tilts(p.spec)
    (s_seq, st_seq), (s_bat, st_bat) = _relax_pair(
        relax, p.state, p.topo, p.params, 40, BENCH_GP["tilt_step_size"], BENCH_GP["tilt_tol"],
        monkeypatch)
    assert st_seq == st_bat
    assert st_seq.accepted_steps > 0
    for f in FIELDS:
        assert torch.equal(getattr(s_seq, f), getattr(s_bat, f)), f


def test_vertex_relax_batched_equals_sequential(monkeypatch):
    from membrane_solver_tpu_torch.runtime import tilt_relax

    ctx, run, _recipe = recipe_context(True, "rect_tilt_source", nx=10, ny=4)
    mn = ctx.minimizer
    p = mn.problem()
    rng = np.random.default_rng(3)
    state = dataclasses.replace(p.state, tilts=p.state.tilts + torch.as_tensor(
        0.05 * rng.standard_normal(tuple(p.state.tilts.shape))))
    relax = tilt_relax.make_relax_vertex_tilts(p.spec)
    step = float(p.params["tilt_step_size"]) if "tilt_step_size" in p.params else 0.1
    (s_seq, n_seq), (s_bat, n_bat) = _relax_pair(relax, state, p.topo, p.params, 20, step, 0.0,
                                                 monkeypatch)
    assert n_seq == n_bat and n_seq > 0
    assert torch.equal(s_seq.tilts, s_bat.tilts)
    energy = jit_core.make_energy_value(p.spec)
    assert torch.equal(energy(s_seq, p.topo, p.params), energy(s_bat, p.topo, p.params))


# ---------------------------------------------- kernel 1 on the member axis
@pytest.mark.parametrize("members", [1, 3, 11])
def test_frozen_tilt_vmap_equals_single_calls(members):
    from membrane_solver_tpu_torch.device.state import corner_csr
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    rng = np.random.default_rng(members)
    N, T = 64, 101
    rows = torch.as_tensor(np.stack([rng.choice(N, 3, replace=False) for _ in range(T)]))
    csr = corner_csr(rows, N)

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    g, payload, k_vec = f32(T, 3, 3), f32(T, 20), f32(6)
    t_in, t_out = f32(members, N, 3), f32(members, N, 3)
    before = dict(ft.LAUNCHES)
    mapped = torch.func.vmap(
        lambda a, b: ft.frozen_tilt_energy(a, b, rows, csr, g, payload, k_vec))(t_in, t_out)
    singles = torch.stack([ft.frozen_tilt_energy(t_in[m].clone(), t_out[m].clone(), rows, csr,
                                                 g, payload, k_vec) for m in range(members)])
    assert mapped.shape == (members,)
    assert torch.equal(mapped, singles)
    assert ft.LAUNCHES == before  # the CPU runs the twins: no launch is counted
    # one mapped operand, the other shared
    shared = torch.func.vmap(
        lambda a: ft.frozen_tilt_energy(a, t_out[0], rows, csr, g, payload, k_vec))(t_in)
    assert torch.equal(shared, torch.stack([
        ft.frozen_tilt_energy(t_in[m].clone(), t_out[0], rows, csr, g, payload, k_vec)
        for m in range(members)]))


def test_frozen_tilt_vmap_refuses_a_mapped_gradient():
    """The member-axis launch refuses a mapped ``tri_rows`` (the rows are shared), and takes a
    mapped tilt gradient with mapped g and payload: each member's energy and gradients the bits
    of its single call."""
    from membrane_solver_tpu_torch.device.state import corner_csr
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    rows = torch.tensor([[0, 1, 2], [1, 2, 3]])
    csr = corner_csr(rows, 4)
    t = torch.ones((2, 4, 3), requires_grad=True)
    with pytest.raises(NotImplementedError, match="member-axis"):
        torch.func.vmap(lambda a, r: ft.frozen_tilt_energy(
            a, a, r, csr, torch.ones((2, 3, 3)), torch.ones((2, 20)), torch.ones(6)))(
                t, torch.stack([rows, rows]))
    rng = np.random.default_rng(5)
    g, payload, k_vec, t_in, t_out = (
        torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
        for shape in ((2, 2, 3, 3), (2, 2, 20), (6,), (2, 4, 3), (2, 4, 3)))
    a, b = t_in.clone().requires_grad_(True), t_out.clone().requires_grad_(True)
    E = torch.func.vmap(lambda x, y, gg, pp: ft.frozen_tilt_energy(x, y, rows, csr, gg, pp,
                                                                   k_vec))(a, b, g, payload)
    gin, gout = torch.autograd.grad(E.sum(), (a, b))
    for m in range(2):
        x, y = t_in[m].clone().requires_grad_(True), t_out[m].clone().requires_grad_(True)
        e = ft.frozen_tilt_energy(x, y, rows, csr, g[m].clone(), payload[m].clone(), k_vec)
        hin, hout = torch.autograd.grad(e, (x, y))
        assert torch.equal(E[m], e) and torch.equal(gin[m], hin) and torch.equal(gout[m], hout)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="the member launch needs a CUDA card")
def test_frozen_tilt_members_launch_equals_single_launches():
    from membrane_solver_tpu_torch.device.state import corner_csr
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    rng = np.random.default_rng(0)
    N, T = 300, 517
    rows = torch.as_tensor(np.stack([rng.choice(N, 3, replace=False) for _ in range(T)]),
                           device="cuda")
    csr = corner_csr(rows, N)

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device="cuda")

    g, payload, k_vec = f32(T, 3, 3), f32(T, 20), f32(6)
    for members in (1, 3, 11):
        t_in, t_out = f32(members, N, 3), f32(members, N, 3)
        mapped = torch.func.vmap(
            lambda a, b: ft.frozen_tilt_energy(a, b, rows, csr, g, payload, k_vec))(t_in, t_out)
        singles = torch.stack([ft.frozen_tilt_energy(t_in[m].clone(), t_out[m].clone(), rows,
                                                     csr, g, payload, k_vec)
                               for m in range(members)])
        assert torch.equal(mapped, singles)


# ------------------------------------------------------------- whole runs
def _digest(state, energies) -> str:
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(getattr(state, f).detach().cpu().numpy().tobytes())
    h.update(np.asarray(energies, dtype=np.float64).tobytes())
    return h.hexdigest()


def _both_forms(run, monkeypatch):
    out = []
    for form in ("0", "1"):
        monkeypatch.setenv(ENV, form)
        out.append(run())
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kozlov_minimize_both_forms(dtype, monkeypatch):
    def run():
        mn = make_minimizer(True, refines=1, dtype=dtype)
        seed_host(mn, 2)
        flags, energies = [], []
        for _ in range(3):
            res = mn.minimize(1)
            flags.append(bool(res["step_success"]))
            energies.append(float(res["energy"]))
        return flags, _digest(mn.problem().state, energies)

    seq, bat = _both_forms(run, monkeypatch)
    assert seq == bat


def test_vesicle_g3_both_forms(monkeypatch):
    from membrane_solver_tpu_torch.commands import CommandContext, execute_command_line

    def run():
        mn = make_vesicle_minimizer(True, refines=2, dtype=torch.float64)
        ctx = CommandContext(mesh=mn.mesh, minimizer=mn, stepper=mn.stepper)
        execute_command_line(ctx, "g3")
        ctx.sync_mesh()
        p = mn.problem()
        return float(mn.compute_energy()), float(mn.step_size), _digest(p.state, [])

    seq, bat = _both_forms(run, monkeypatch)
    assert seq == bat


def test_tensor_parallel_block_both_forms(monkeypatch):
    from membrane_solver_tpu_torch.parallel import tensor as tp

    def run():
        mn = make_minimizer(True, refines=1, dtype=torch.float64)
        seed_host(mn, 4)
        p = mn.problem()
        mesh = tp.tp_mesh(devices=["cpu"] * 2)
        state, topo = tp.shard_problem(p, mesh)
        opts = jit_core.MinimizeOptions(step_size_mode="fixed", enforce_in_line_search=True)
        ss = jit_core.fresh_stepper_state(state.positions.shape[0], dtype=torch.float64)
        block = tp.tp_minimize_block(p.spec, opts, mesh)
        state, _ss, stats = block(state, topo, p.params, ss, 2, 0.5, 0.5, 1e-12, 1e-10, 3, 0,
                                  int(BENCH_GP["tilt_inner_steps"]))
        return stats.accepted_steps, stats.step_success, _digest(state, [stats.energy])

    seq, bat = _both_forms(run, monkeypatch)
    assert seq == bat
