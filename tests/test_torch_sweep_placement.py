"""The parameter sweep placed on a list of devices (``parallel/sweep``, ``device_mesh``).

The JAX package's ``tests/test_sweep_parallel.py`` shards eight members of
kozlov_1disk over 8 virtual CPU devices and holds member 0 to its unsharded
run.  The port's mesh is an ordered list of torch devices; on the CPU,
``["cpu"] * n``: B members split into contiguous groups of B/n in member
order, one group per listed device, each running the member block.

Held here: four members of the seeded kozlov L0 sweep (``tests/test_torch_sweep.py``'s
dilation, modulus and theta_B scan) placed on ``["cpu"] * 2`` and
``["cpu"] * 4`` under three option sets against the unplaced sweep (each
member within 1e-12, every flag equal; its bits under gradient descent and
CG, where nothing a member computes depends on how many run with it; BFGS's
batched products of H do), two placed runs in
bits, member 0 against the JAX package's unsharded ``run_sweep`` (rel 1e-8,
one vmapped JAX sweep), the groups and their launch records, and a
ValueError when the mesh does not divide the members.  The card runs phase
33's protocol on ``[cuda:0] * 2``, ``[cuda:0] * 4`` and ``[cuda:0, cpu]``
(``chip_smoke.py`` phase 53).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port_harness import make_minimizer, seed_host, to_np

from membrane_solver_tpu_torch.parallel import sweep
from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

B = 4
STEPS = 2
STEP_SIZE = 1e-3
SEED = 5
OPTIONS = {
    "default": {},
    "cg_fixed": {"stepper": "conjugate_gradient", "step_size_mode": "fixed"},
    "bfgs": {"stepper": "bfgs"},
}
STATS = ("energy", "accepted_energy", "grad_norm", "step_size")
FLAGS = ("step_success", "iterations", "converged", "terminated_early", "zero_step_counter",
         "trials", "accepted_steps", "trace_z_fallbacks")
FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")
MEMBER_REL = 1e-12


def members(params, positions):
    """The dilation, modulus and theta_B scan of ``tests/test_torch_sweep.py``, B members."""
    k_in, theta = float(params["tilt_modulus_in"]), float(params["tilt_thetaB_value"])
    return ([{"tilt_modulus_in": k_in * (1.0 + 0.1 * m), "tilt_thetaB_value": theta + 0.01 * m}
             for m in range(B)], [positions * (1.0 + 0.01 * m) for m in range(B)])


@pytest.fixture(scope="module")
def problem():
    tm = make_minimizer(True, device="cpu", dtype=torch.float64)
    seed_host(tm, SEED)
    return tm.problem()


def run(p, options: dict, mesh=None, count=B):
    params, positions = members(p.params, p.state.positions.numpy())
    return sweep.run_sweep(p, params[:count], STEPS, step_size=STEP_SIZE,
                           options=MinimizeOptions(**options), device_mesh=mesh,
                           member_positions=positions[:count])


@pytest.fixture(scope="module")
def unplaced(problem):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run(problem, OPTIONS[name])
        return cache[name]

    return get


def assert_members_equal(got, want, rel: float) -> None:
    (g_states, g_ss, g_stats), (w_states, w_ss, w_stats) = got, want
    for key in STATS:
        g, w = np.asarray(getattr(g_stats, key)), np.asarray(getattr(w_stats, key))
        assert np.all(np.abs(g - w) <= rel * np.abs(w)), f"{key}: {g} vs {w}"
    for key in FLAGS:
        assert np.array_equal(np.asarray(getattr(g_stats, key)),
                              np.asarray(getattr(w_stats, key))), key
    for f in FIELDS:
        g, w = to_np(getattr(g_states, f)), to_np(getattr(w_states, f))
        for m in range(B):
            scale = max(float(np.max(np.abs(w[m]))), 1.0)
            assert float(np.max(np.abs(g[m] - w[m]))) <= rel * scale, f"{f} member {m}"
    for f in dataclasses.fields(g_ss):
        g, w = getattr(g_ss, f.name), getattr(w_ss, f.name)
        if isinstance(w, torch.Tensor):
            scale = max(float(torch.max(torch.abs(w))), 1.0)
            assert float(torch.max(torch.abs(g - w))) <= rel * scale, f.name
        elif w is not None:
            assert np.array_equal(np.asarray(g), np.asarray(w)), f.name


@pytest.mark.parametrize("name", list(OPTIONS))
@pytest.mark.parametrize("n_devices", [2, 4])
def test_placed_members_equal_the_unplaced_sweep(problem, unplaced, n_devices, name):
    got = run(problem, OPTIONS[name], ["cpu"] * n_devices)
    assert_members_equal(got, unplaced(name), MEMBER_REL)
    # every member took real steps and the groups kept the member order
    assert np.asarray(got[2].iterations).tolist() == [STEPS] * B
    assert len(np.unique(np.round(np.asarray(got[2].energy), 9))) == B
    # gradient descent and CG: in fact the same bits, each member's decisions and sums are its
    # own; BFGS's batched H products add in an order that depends on the group's size
    if name != "bfgs":
        for f in FIELDS:
            assert torch.equal(getattr(got[0], f), getattr(unplaced(name)[0], f)), f


def test_two_placed_runs_give_the_same_bits(problem):
    a, b = run(problem, OPTIONS["cg_fixed"], ["cpu"] * 2), run(problem, OPTIONS["cg_fixed"],
                                                                ["cpu"] * 2)
    for f in FIELDS:
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    for key in STATS:
        assert np.array_equal(np.asarray(getattr(a[2], key)), np.asarray(getattr(b[2], key)))


def test_groups_are_recorded_in_member_order(problem):
    sweep.GROUP_RECORD = []
    try:
        states, _ss, stats = run(problem, OPTIONS["default"], ["cpu"] * 4)
        record = sweep.GROUP_RECORD
    finally:
        sweep.GROUP_RECORD = None
    assert [(str(d), span) for d, span, _l in record] == [
        ("cpu", (0, 1)), ("cpu", (1, 2)), ("cpu", (2, 3)), ("cpu", (3, 4))]
    assert all(launches == {} for _d, _s, launches in record)  # the CPU twins launch nothing
    assert states.positions.device == torch.device("cpu")
    assert all(np.asarray(getattr(stats, f.name)).shape == (B,)
               for f in dataclasses.fields(stats))


def test_member_zero_matches_the_jax_unsharded_sweep(problem):
    """Member 0 of the placed sweep against JAX's unsharded vmapped ``run_sweep``."""
    from membrane_solver_tpu.parallel.sweep import run_sweep as jax_run_sweep

    jm = make_minimizer(False)
    seed_host(jm, SEED)
    jp = jm.problem()
    params, positions = members(jp.params, np.asarray(jp.state.positions))
    j_states, _j_ss, j_stats = jax_run_sweep(jp, params[:1], STEPS, step_size=STEP_SIZE,
                                             member_positions=positions[:1])
    states, _ss, stats = run(problem, OPTIONS["default"], ["cpu"] * 2)
    n = problem.n_vertices
    for key in STATS:
        w = float(np.asarray(getattr(j_stats, key))[0])
        assert abs(float(np.asarray(getattr(stats, key))[0]) - w) <= 1e-8 * abs(w), key
    for f in ("positions", "tilts_in", "tilts_out"):
        w = to_np(getattr(j_states, f))[0, :n]
        g = to_np(getattr(states, f))[0]
        assert float(np.max(np.abs(g - w))) <= 1e-8 * max(float(np.max(np.abs(w))), 1.0), f


@pytest.mark.parametrize("n_devices", [3, 8])
def test_a_mesh_that_does_not_divide_the_members_raises(problem, n_devices):
    with pytest.raises(ValueError, match=f"{B} sweep members do not split over {n_devices}"):
        run(problem, OPTIONS["default"], ["cpu"] * n_devices)


def test_sweep_mesh_forms():
    assert sweep.sweep_mesh(["cpu", "cpu:0"]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="at least one device"):
        sweep.sweep_mesh([])
