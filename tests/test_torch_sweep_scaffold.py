"""The scaffold-trace lane and its ``trace_z`` fallback in the parameter sweep, against the JAX package's.

The lane of ``tests/fixtures/torch_port/kozlov_L3_scaffold_sweep_f64_jax.json``
(the physical-edge rim placement with the trace shell, its projection in
every trial, the theory-parity and trace-reconstructed divergences and the
rejected-step ``trace_z`` fallback) at L0, as
``tests/test_torch_sweep_physical_edge.py`` runs its lane: the JAX lane's
state after its protocol steps starts both sweeps; three steps at the
lane's own step size (0.005), enforcing in every trial.  Per member the
stats and the final positions and tilts at rel 1e-10, equal flags; per
member and iteration the fallback's viability (the first search failed and
the mean trace-z descent is finite and positive) and its search's accept
flag equal to JAX's (``record_torch_port_fixture.fallback_recorder``: under
``vmap`` JAX's ``lax.cond`` becomes a select, and its flags come from the
searches it ran); member m against a one-member sweep of member m in bits;
the port's single-problem block on each member (no relax, the sweep's
options) against the member block: fallback counts equal, energies at
1e-12.  The lane's rim KKT system is singular (several conditions per
shell row): the port's equals the JAX package's in bits, and LAPACK's LU,
like the card's, meets exact zero pivots there and skips the projection,
where PyTorch's CPU LU (MKL's) meets pivots of 1e-19 and projects (ROADMAP
C11).  So this file's port runs factor their shape KKT systems with the
JAX package's CPU LU.

The scaffold lane's items mapped over members (``chip_smoke.physical_edge_items``,
card phase 52's: the four tilt energies with their gradients, the rim
placement's compact rows, its tilt enforcement and its trace-shell
projection) against the JAX package's ``jax.vmap`` at rel 1e-12 and member
by member against their single calls in bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_sweep_interface import STATS, assert_member_bits, assert_members_close
from tests.test_torch_sweep_physical_edge import (
    ITEMS,
    REL,
    assert_lane_items,
    assert_levels_built_before_the_map,
    fixture,
    lane_pair,
    sweep,
)

SWEEP = "kozlov_L3_scaffold_sweep_f64_jax.json"
SINGLE_REL = 1e-12
ENERGIES = ("tilt_in", "tilt_out", "bending_tilt_in", "bending_tilt_out")


def port_sweep_with_flags(problem, protocol: dict):
    """The port's sweep and, per member, its fallback's (viable, accepted) flags per iteration
    (``member_block.TRACE_Z_RECORD``)."""
    from membrane_solver_tpu_torch.parallel import member_block

    member_block.TRACE_Z_RECORD = []
    try:
        out = sweep(problem, protocol, True)
        rec = member_block.TRACE_Z_RECORD
    finally:
        member_block.TRACE_Z_RECORD = None
    B = protocol["members"]
    return out, ([[bool(v[m]) for live, v, _a in rec if live[m]] for m in range(B)],
                 [[bool(a[m]) for live, _v, a in rec if live[m]] for m in range(B)])


def jax_sweep_with_flags(problem, protocol: dict):
    """JAX's vmapped sweep and its per-member fallback flags (``fallback_flags``)."""
    import jax

    from membrane_solver_tpu.runtime import jit_core as jcore
    from tools.record_torch_port_fixture import fallback_flags, fallback_recorder

    original = jcore.armijo_line_search
    # the recorder reaches only blocks traced after it, and the blocks traced with it must
    # not be reused once it is gone: JAX's caches are cleared on both sides
    jax.clear_caches()
    try:
        recorded = fallback_recorder()
        out = sweep(problem, protocol, False)
        jax.effects_barrier()
    finally:
        jcore.armijo_line_search = original
        jax.clear_caches()
    return out, fallback_flags(recorded, protocol["members"], np.asarray(out[2].iterations))


def jax_lu_factor_ex(A):
    """``torch.linalg.lu_factor_ex`` through the JAX package's CPU LU (LAPACK ``getrf``)."""
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl

    lu, piv = jsl.lu_factor(jnp.asarray(A.detach().numpy()))
    return (torch.as_tensor(np.array(lu)), torch.as_tensor(np.asarray(piv) + 1, dtype=torch.int32),
            torch.zeros((), dtype=torch.int32))


@pytest.fixture(scope="module")
def scaffold_lane():
    """The lane pair and the port's sweep, the port's shape KKT systems factored by the JAX
    package's CPU LU throughout the module (ROADMAP C11: the lane's rim system is singular;
    LAPACK and the card's LU meet exact zero pivots there and skip the projection, as JAX
    does, where PyTorch's CPU LU meets pivots of 1e-19 and projects)."""
    protocol = fixture(SWEEP)["protocol"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.linalg, "lu_factor_ex", jax_lu_factor_ex)
        jp, tp = lane_pair(protocol)
        got, flags = port_sweep_with_flags(tp, protocol)
        yield protocol, jp, tp, got, flags


def test_the_rim_kkt_system_is_jax_bits_and_singular(scaffold_lane):
    """C11: the port's shape KKT system of the lane's start equals the JAX package's in bits;
    LAPACK's partial-pivoting elimination meets exact zero pivots on it, so JAX's multipliers
    are non-finite and its projection is skipped (as the port's on the card, phase 28)."""
    import warnings

    import jax
    import scipy.linalg

    from membrane_solver_tpu.runtime import jit_core as jcore
    from membrane_solver_tpu_torch.runtime import jit_core as tcore

    _protocol, jp, tp, _got, _flags = scaffold_lane
    seen = {}
    port_solve, jax_solve = tcore.solve_kkt_with_rescue, jcore._solve_kkt_with_rescue

    def port_capture(A, b):
        seen["port"] = A.numpy().copy()
        return port_solve(A, b)

    def jax_capture(A, b, k):
        jax.debug.callback(lambda a: seen.__setitem__("jax", np.asarray(a)), A)
        return jax_solve(A, b, k)

    jax.clear_caches()
    try:
        tcore.solve_kkt_with_rescue, jcore._solve_kkt_with_rescue = port_capture, jax_capture
        tcore.make_energy_and_grad(tp.spec)(tp.state, tp.topo, tp.params)
        jcore.make_energy_and_grad(jp.spec)(jp.state, jp.topo, jp.params)
        jax.effects_barrier()
    finally:
        tcore.solve_kkt_with_rescue, jcore._solve_kkt_with_rescue = port_solve, jax_solve
        jax.clear_caches()
    k = seen["port"].shape[0]
    assert np.array_equal(seen["port"], seen["jax"][:k, :k])  # JAX pads the rim's rings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
        lu, _piv = scipy.linalg.lu_factor(seen["port"], check_finite=False)
    assert np.sum(np.diag(lu) == 0.0) > 0


def test_scaffold_sweep_matches_jax_with_its_fallbacks(scaffold_lane):
    protocol, jp, tp, got, (viable, accepted) = scaffold_lane
    want, (jax_viable, jax_accepted) = jax_sweep_with_flags(jp, protocol)
    assert_members_close(got, want, tp.n_vertices, REL)
    assert (viable, accepted) == (jax_viable, jax_accepted)
    assert any(map(any, viable))  # the fallback runs at L0 too
    fallbacks = np.asarray(got[2].trace_z_fallbacks).tolist()
    assert fallbacks == [sum(v) for v in jax_viable]


def test_member_equals_its_one_member_sweep_in_bits(scaffold_lane):
    protocol, _jp, tp, got, _flags = scaffold_lane
    assert_member_bits(got, tp, protocol, port_sweep=sweep)
    for m in range(protocol["members"]):
        one = sweep(tp, protocol, True, pick=m)[2]
        assert int(one.trace_z_fallbacks[0]) == int(got[2].trace_z_fallbacks[m]), m


def test_single_block_agrees_with_the_member_block(scaffold_lane):
    """Each member through the single-problem block (``jit_core.minimize_block`` with no relax,
    as the sweep runs none), with the sweep's options, step size and counters."""
    from chip_smoke import sweep_members, sweep_options
    from membrane_solver_tpu_torch.device.state import MeshState
    from membrane_solver_tpu_torch.parallel.sweep import batch_problem
    from membrane_solver_tpu_torch.runtime import jit_core

    protocol, _jp, tp, got, _flags = scaffold_lane
    options = jit_core.MinimizeOptions(**sweep_options(protocol))
    spec = dataclasses.replace(tp.spec, static_options=(("tilt_solve_mode", "fixed"),)
                               + tp.spec.static_options)
    block = jit_core.minimize_block(spec, options)
    params, positions = sweep_members(protocol, tp.state.positions.numpy(), tp.params)
    batch = batch_problem(tp, params, member_positions=positions)
    step = protocol["step_size"]
    for m in range(protocol["members"]):
        state = MeshState(*(getattr(batch.states, f.name)[m]
                            for f in dataclasses.fields(MeshState)))
        ss = jit_core.fresh_stepper_state(tp.n_vertices, options.stepper, dtype=torch.float64,
                                          device=state.positions.device)
        _st, _ss, stats = block(state, tp.topo, {k: v[m] for k, v in batch.params.items()}, ss,
                                protocol["steps"], step, step, 1e-6, 1e-8, 10, 0, 0)
        assert stats.trace_z_fallbacks == int(got[2].trace_z_fallbacks[m]), m
        assert stats.iterations == int(got[2].iterations[m]), m
        for key in STATS:
            one, member = getattr(stats, key), float(getattr(got[2], key)[m])
            assert abs(one - member) <= SINGLE_REL * abs(member), f"{key} member {m}"


def test_levels_are_built_before_the_map(scaffold_lane, monkeypatch):
    protocol, _jp, tp, got, _flags = scaffold_lane
    assert_levels_built_before_the_map(tp, protocol, got, monkeypatch)


@pytest.mark.parametrize("item", ITEMS)
def test_rim_items_match_jax_vmap_and_their_single_calls(item):
    assert_lane_items("scaffold", f"constraint/rim_slope_match_out/scaffold/{item}")


@pytest.mark.parametrize("module", ENERGIES)
def test_energy_matches_jax_vmap_and_its_single_calls(module):
    assert_lane_items("scaffold", f"energy/{module}")
