"""The ``Minimizer`` surface and the theta_B scan in the port against the JAX package.

On the CPU at float64, on meshgen ``kozlov_1disk`` at the ``SMALL`` size:

- the scan (``tilt_thetaB_optimize``, every iteration, delta 0.01, the
  parameters of ``tests/test_inloop_relax_semantics.py``): the state the
  scan scores is this iteration's guarded relax of the state after the
  minimize-entry enforcement (relax -> scan -> step, atol 1e-14), and
  ``minimize(3)`` writes the JAX package's ``_thetaB_scan_trace`` records
  (equal keys, flags and selected theta_B; energies and breakdowns within
  rel 1e-12) and ends within rel 1e-12 of its energy;
- the dynamic-only refresh: a change of ``tilt_thetaB_value`` alone keeps
  the compiled problem, the stepper history and the compile count, and a
  change of any other key recompiles;
- the guarded relax with a factor that makes every attempt spike (all
  retries, then the entry state), with a retry count of its own, and with
  a factor that accepts: the attempts made and the tilts within 1e-12 of
  the JAX package's;
- ``tilt_solve_mode`` ``nested`` and ``fixed``: ``minimize(2)`` within rel
  1e-12;
- ``minimize(0)``, ``compute_energy_and_gradient(_array)``,
  ``relax_leaflet_tilts`` and ``reset_soa_caches``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from _torch_port_harness import BENCH_GP, SMALL, assert_close, make_minimizer, port_from_jax

RTOL = 1e-12
SCAN_GP = {
    "tilt_solve_mode": "coupled",
    "tilt_step_size": 0.15,
    "tilt_inner_steps": 6,
    "tilt_tol": 1e-10,
    "tilt_thetaB_optimize": True,
    "tilt_thetaB_optimize_every": 1,
    "tilt_thetaB_optimize_delta": 0.01,
    "tilt_thetaB_optimize_inner_steps": 4,
    "tilt_thetaB_value": 0.05,
}


def _pair(gp):
    full = {**BENCH_GP, **gp}
    return (make_minimizer(False, SMALL, gp=full),
            make_minimizer(True, SMALL, gp=full, dtype=torch.float64))


def _port_scan_minimizer():
    return make_minimizer(True, SMALL, gp={**BENCH_GP, **SCAN_GP}, dtype=torch.float64)


# ----------------------------------------------------------------------
# the scan
# ----------------------------------------------------------------------
def test_scan_iteration_relaxes_before_scoring(monkeypatch):
    """The state the scan scores equals guarded_relax(the state after the entry enforcement)."""
    from membrane_solver_tpu_torch.runtime import jit_core
    from membrane_solver_tpu_torch.runtime import tilt_optimization as topt

    captured = {}
    orig = topt.optimize_thetaB_scalar

    def spy(minimizer, *, tilt_mode, iteration):
        if "tin" not in captured:
            p = minimizer.problem()
            captured["tin"], captured["tout"] = p.state.tilts_in, p.state.tilts_out
        return orig(minimizer, tilt_mode=tilt_mode, iteration=iteration)

    monkeypatch.setattr(topt, "optimize_thetaB_scalar", spy)
    _port_scan_minimizer().minimize(1)
    assert "tin" in captured, "the scan did not run"

    mn2 = _port_scan_minimizer()
    mn2.enforce_constraints_after_mesh_ops()
    p2 = mn2.problem()
    st = jit_core.make_guarded_relax(p2.spec)(p2.state, p2.topo, p2.params, 6)
    assert_close(captured["tin"], st.tilts_in, 1e-14, "scored tilts_in", atol_scale=1.0)
    assert_close(captured["tout"], st.tilts_out, 1e-14, "scored tilts_out", atol_scale=1.0)
    assert float(torch.max(torch.abs(captured["tin"]))) > 0.0


@pytest.fixture(scope="module")
def scan_runs():
    """minimize(3) with the scan in both packages: (JAX minimizer, result), (port, result)."""
    jm, tm = _pair(SCAN_GP)
    return (jm, jm.minimize(3)), (tm, tm.minimize(3))


def test_scan_records_match_jax(scan_runs):
    (jm, jres), (tm, tres) = scan_runs
    want, got = jm.mesh._thetaB_scan_trace, tm.mesh._thetaB_scan_trace
    assert len(got) == len(want) == 3
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for key in ("iteration", "status", "base_thetaB", "selected_thetaB"):
            assert g[key] == w[key], key
        for gc, wc in zip(g["candidate_energies"], w["candidate_energies"], strict=True):
            assert set(gc) == set(wc)
            assert gc["thetaB"] == wc["thetaB"] and gc["discarded"] == wc["discarded"]
            for key in set(wc) - {"thetaB", "discarded"}:
                assert gc[key] == pytest.approx(wc[key], rel=RTOL, abs=1e-15), key
    assert [r["selected_thetaB"] for r in got] != [SCAN_GP["tilt_thetaB_value"]] * 3
    assert tm.global_params.get("tilt_thetaB_value") == jm.global_params.get("tilt_thetaB_value")
    assert tres["energy"] == pytest.approx(jres["energy"], rel=RTOL, abs=1e-15)
    assert tres["iterations"] == jres["iterations"] == 3


def test_the_scan_does_not_recompile(monkeypatch):
    """After the entry enforcement, the scan's theta_B writes refresh the parameters only."""
    from membrane_solver_tpu_torch.device import state as tstate

    mn = _port_scan_minimizer()
    seen = []
    mn.minimize(3, callback=lambda _mesh, _i: seen.append(tstate.COMPILES["compile_state"]))
    assert len(seen) == 3 and seen[0] == seen[-1] == tstate.COMPILES["compile_state"]
    assert len(mn.mesh._thetaB_scan_trace) == 3


def test_dynamic_only_refresh_keeps_the_problem():
    from membrane_solver_tpu_torch.device import state as tstate

    mn = _port_scan_minimizer()
    p = mn.problem()
    stepper_state = mn._stepper_state
    compiles = tstate.COMPILES["compile_state"]
    mn.global_params.set("tilt_thetaB_value", 0.125)
    assert mn.problem() is p and mn._stepper_state is stepper_state
    assert float(p.params["tilt_thetaB_value"]) == 0.125
    assert tstate.COMPILES["compile_state"] == compiles
    mn.global_params.set("tilt_step_size", 0.1)
    assert mn.problem() is not p
    assert tstate.COMPILES["compile_state"] == compiles + 1


# ----------------------------------------------------------------------
# the guarded relax
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "factor,retries,attempts",
    [(1e-9, None, 5), (1e-9, 1, 2), (1.0, None, 1)],
    ids=["every-attempt-spikes", "one-retry", "accepted"],
)
def test_guarded_relax_matches_jax(monkeypatch, factor, retries, attempts):
    import jax.numpy as jnp

    from membrane_solver_tpu.runtime import jit_core as jcore
    from membrane_solver_tpu_torch.runtime import jit_core as tcore
    from membrane_solver_tpu_torch.runtime import tilt_relax as trelax

    gp = {"tilt_relax_energy_guard_factor": factor, "tilt_inner_steps": 6}
    if retries is not None:
        gp["tilt_relax_energy_guard_retries"] = retries
    jm, tm = _pair(gp)
    for mn in (jm, tm):
        mn.enforce_constraints_after_mesh_ops()
    jp, tp = jm.problem(), tm.problem()
    assert dict(tp.spec.static_options)["tilt_guard"] == "on"

    calls = []
    real = trelax.make_relax_leaflet_tilts

    def counting(spec):
        relax = real(spec)

        def run(*args):
            calls.append(args[4])
            return relax(*args)

        return run

    monkeypatch.setattr(trelax, "make_relax_leaflet_tilts", counting)
    _state, topo, params = port_from_jax(jp)
    got = tcore.make_guarded_relax(tp.spec)(tp.state, topo, params, 6)
    want = jcore.make_guarded_relax(jp.spec)(jp.state, jp.topo, jp.params,
                                             jnp.asarray(6, jnp.int32))
    assert len(calls) == attempts
    assert calls == [0.15 * 0.5**k for k in range(attempts)]
    for field in ("tilts_in", "tilts_out"):
        want_f = np.asarray(getattr(want, field))[: jp.n_vertices]
        assert_close(getattr(got, field), want_f, RTOL, field, atol_scale=1.0)
        rolled_back = np.array_equal(want_f, np.asarray(getattr(jp.state, field))[: jp.n_vertices])
        assert rolled_back == (factor < 1.0)


# ----------------------------------------------------------------------
# tilt_solve_mode and the Minimizer surface
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["nested", "fixed"])
def test_tilt_solve_mode_matches_jax(mode):
    jm, tm = _pair({"tilt_solve_mode": mode, "tilt_inner_steps": 6})
    jres, tres = jm.minimize(2), tm.minimize(2)
    assert tres["energy"] == pytest.approx(jres["energy"], rel=RTOL)
    assert tm.step_size == jm.step_size


def test_minimize_zero_and_energy_and_gradient_match_jax():
    jm, tm = _pair({})
    E_j, g_j = jm.compute_energy_and_gradient_array()
    E_t, g_t = tm.compute_energy_and_gradient_array()
    assert E_t == pytest.approx(E_j, rel=RTOL)
    assert_close(g_t, g_j[: len(g_t)], RTOL, "projected shape gradient", atol_scale=1.0)
    _E, grad = tm.compute_energy_and_gradient()
    assert set(grad) == set(tm.mesh.vertices)
    jres, tres = jm.minimize(0), tm.minimize(0)
    assert tres["iterations"] == jres["iterations"] == 0
    assert tres["terminated_early"] and tres["step_success"]
    assert tres["energy"] == pytest.approx(jres["energy"], rel=RTOL)
    assert set(tres["gradient"]) == set(jres["gradient"])
    for vid, row in jres["gradient"].items():
        np.testing.assert_allclose(tres["gradient"][vid], row, rtol=0, atol=1e-12)


def test_relax_leaflet_tilts_commits_as_jax():
    jm, tm = _pair({})
    js, ts = jm.relax_leaflet_tilts(max_iters=6), tm.relax_leaflet_tilts(max_iters=6)
    assert ts["accepted_steps"] == js["accepted_steps"] > 0
    assert ts["final_energy"] == pytest.approx(js["final_energy"], rel=RTOL)
    assert tm.compute_energy() == pytest.approx(jm.compute_energy(), rel=RTOL)
    p = tm.problem()
    tm.reset_soa_caches()
    assert tm._problem is None and tm.problem() is not p
