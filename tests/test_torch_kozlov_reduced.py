"""The kozlov lane's solver options through ``minimize``: the port against the JAX package.

float64, meshgen ``kozlov_1disk`` at L0 (177 vertices):

- ``minimize(1)`` twice, from the lane's start, with the options of
  ``tests/test_torch_kozlov_options.py`` in groups (each group one JAX
  minimize block to trace; the third, the ring-average mode with the
  ablation and the unpreconditioned CG, is in
  ``tests/test_torch_rim_modes.py``): per step the energy within rel 1e-10 and
  the same accept flag; the final positions and tilts within rel 1e-10 of
  their scale or, where larger, twice the JAX package's own spread under
  1e-15 of position noise (the relaxes' accept-if-not-worse tests amplify
  round-off, ROADMAP C3: on the reduced group 1e-15 grows to 1e-2 in the
  JAX package alone, while the port stays within 1e-8 of it).
  With the reduced-energy line search on, the accepted step keeps its
  trial's relaxed tilts: the port's equal the JAX package's, and differ
  from the port's own run with the reduced line search off;
- ``decrease_only`` against ``armijo`` on a zero direction, and the CG's
  GD retry of a rejected direction (one leaflet relax).

The theta_B scan under the reduced line search is in
``tests/test_torch_kozlov_reduced_scan.py``.

The card lane's protocol at L0 is in ``tests/test_torch_kozlov_reduced_lane.py``.
``check_minimize`` is the shared test body.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import (
    BANDS,
    OPTION_GP,
    assert_steps,
    host_state,
    jax_noise_state,
    make_minimizer,
    option_minimizers,
    steps_of,
)

from membrane_solver_tpu.device.state import build_params as jbuild_params
from membrane_solver_tpu.runtime import jit_core as jcore
from membrane_solver_tpu.runtime import tilt_relax as jrelax
from membrane_solver_tpu_torch.runtime import jit_core as tcore
from membrane_solver_tpu_torch.runtime import tilt_relax as trelax

REL = 1e-10
TOL = 1e-12
GROUPS = {
    "reduced_solver_options": {
        "line_search_reduced_energy": "on",
        "tilt_cg_rejection_fallback": "gd",
        "tilt_projection_cadence": "per_pass",
        "rim_slope_match_kkt_rows": "reference_exact",
    },
    "decrease_only_staggered": {
        "line_search_reduced_energy": "on",
        "line_search_reduced_accept_rule": "decrease_only",
        "rim_slope_match_mode": "shared_rim_staggered_v1",
        "tilt_axisymmetric_about_thetaB_center": True,
        "inner_coupled_update_mode": "rim_matched_radial_continuation_v1",
        **BANDS,
    },
}


def check_minimize(group: dict) -> None:
    """Two ``minimize(1)`` of the lane with ``group``'s options in both packages, compared."""
    gp = {**OPTION_GP, **group}
    jm = make_minimizer(False, gp=gp)
    tm = make_minimizer(True, gp=gp, dtype=torch.float64)
    steps = steps_of(jm, tm, 2)
    assert_steps(steps, jm, tm, REL, noisy=jax_noise_state(gp, 2))
    if gp.get("line_search_reduced_energy") == "on" and any(t["step_success"] for _j, t in steps):
        plain = make_minimizer(True, gp={**gp, "line_search_reduced_energy": "off"},
                               dtype=torch.float64)
        plain.minimize(2)
        assert not np.array_equal(host_state(plain)["tilt_in"], host_state(tm)["tilt_in"])


@pytest.mark.parametrize("name", list(GROUPS))
def test_minimize_matches_jax(name):
    check_minimize(GROUPS[name])


@pytest.mark.parametrize("rule", ["decrease_only", "armijo"])
def test_accept_rule_on_a_zero_direction(rule):
    """decrease_only accepts a non-increasing trial along a non-descent direction; armijo skips it."""
    jm, tm = option_minimizers({})
    jp, tp = jm.problem(), tm.problem()
    jparams = jbuild_params(jm.mesh)
    jtotal = jcore.make_total_energy(jp.spec)
    jzero = jnp.zeros_like(jp.state.positions)
    jls = jcore.armijo_line_search(
        lambda st: jtotal(st, jp.topo, jparams), jp.state, jzero, jzero,
        jnp.asarray(0.01, jnp.float64), jtotal(jp.state, jp.topo, jparams),
        jp.topo.vertex_valid & ~jp.topo.fixed_mask, jp.topo,
        lambda pos: dataclasses.replace(jp.state, positions=pos), accept_rule=rule)
    value = tcore.make_energy_value(tp.spec)
    tzero = torch.zeros_like(tp.state.positions)
    tls = tcore.armijo_line_search(
        lambda st: value(st, tp.topo, tp.params), tp.state, tzero, tzero, 0.01,
        float(value(tp.state, tp.topo, tp.params)), ~tp.topo.fixed_mask, tp.topo,
        lambda pos: dataclasses.replace(tp.state, positions=pos), accept_rule=rule)
    assert tls.success == bool(jls.success) == (rule == "decrease_only")
    assert tls.new_step == pytest.approx(float(jls.new_step), rel=1e-15)
    assert tls.energy == pytest.approx(float(jls.energy), rel=1e-14)


def test_rejection_fallback_retries_a_rejected_cg_direction(monkeypatch):
    """At step 5 the CG direction is rejected once the relax converges: the retry runs, then fails.

    Both packages end rejected, on the same energy (rel 1e-12; the relax
    stops at its float64 floor, ROADMAP C3, where near-ties part the
    accepted counts by a step or two, so counts and tilts are not held
    here), and the port's retry backtracks once more than the same relax
    without the fallback.
    """
    calls = []
    backtrack = trelax._backtrack

    def spy(*args, **kw):
        calls.append(1)
        return backtrack(*args, **kw)

    monkeypatch.setattr(trelax, "_backtrack", spy)
    counts = {}
    for fallback in ("off", "gd"):
        jm, tm = option_minimizers({"tilt_cg_rejection_fallback": fallback})
        jp, tp = jm.problem(), tm.problem()
        jout, jstats = jrelax.make_relax_leaflet_tilts(jp.spec)(
            jp.state, jp.topo, jbuild_params(jm.mesh), jnp.asarray(40, jnp.int32),
            jnp.asarray(5.0, jnp.float64), jnp.asarray(TOL, jnp.float64))
        calls.clear()
        _tout, tstats = trelax.make_relax_leaflet_tilts(tp.spec)(tp.state, tp.topo, tp.params,
                                                                 40, 5.0, TOL)
        counts[fallback] = len(calls)
        assert tstats.rejected and bool(jstats.rejected)
        assert tstats.final_energy == pytest.approx(float(jstats.final_energy), rel=1e-12)
    assert counts["gd"] == counts["off"] + 1
