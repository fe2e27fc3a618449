"""The theta_B contact term's legacy penalty and field-linear work, and the J0-fit lane (float64).

Against the JAX package on meshgen ``kozlov_1disk`` (177 vertices):

- ``tilt_thetaB_contact_in``'s energy and gradients under the legacy
  penalty, the ``field_linear`` work mode and both, full and frozen split,
  on seeded states (``_torch_port_harness.seeded_pair``), at rel 1e-12;
- ``scalar_update_live`` and the closed-form ``update_scalar_params`` on a
  seeded host state (the ring in angular order about the given normal and
  about the group's least-squares normal), at rel 1e-12;
- ``Minimizer.minimize`` with the legacy penalty: one host update per
  iteration, no compile after the minimize entry, and the update skipped
  under ``tilt_thetaB_optimize``;
- ``minimize(2)`` of the ``kozlov_L3_J0_fit`` protocol
  (``tools/record_torch_port_fixture.py``) at L0 against the JAX package's
  run of it (``tests/fixtures/torch_port/J0_fit_noise.json``, its clean L0
  run), step for step: accept flags, energies and theta_B within twice the
  JAX package's own spread under 1e-15 of height noise (or round-off, when
  larger; the same file), the fitted rim circle and the slide plane offset
  at round-off.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_port_harness import BENCH_GP, assert_close, energy_and_grads, make_minimizer, \
    port_from_jax, seeded_pair

REL = 1e-12
FIXTURES = Path(__file__).parent / "fixtures" / "torch_port"
J0_FIT = json.loads((FIXTURES / "kozlov_L3_J0_fit_f64_jax.json").read_text())["protocol"]
J0_NOISE = json.loads((FIXTURES / "J0_fit_noise.json").read_text())["levels"]["lane L0"]
MODES = {
    "legacy": {"tilt_thetaB_contact_penalty_mode": "legacy"},
    "on": {"tilt_thetaB_contact_penalty_mode": "on"},
    "field_linear": {"tilt_thetaB_contact_work_mode": "field_linear"},
    "both": {"tilt_thetaB_contact_penalty_mode": "true",
             "tilt_thetaB_contact_work_mode": "field_linear"},
}
NAME = "tilt_thetaB_contact_in"
_CACHE: dict = {}


def case(mode: str):
    if mode in _CACHE:
        return _CACHE[mode]
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu.meshgen import build

    def mesh(pkg):
        m = pkg.parse_geometry(build("kozlov_1disk"))
        m.global_parameters.update({**BENCH_GP, **MODES[mode]})
        return m

    jp = jpkg.Minimizer(mesh(jpkg), quiet=True).problem()
    tspec = tpkg.Minimizer(mesh(tpkg), quiet=True, device="cpu").problem().spec
    js, ts = seeded_pair(jp, 6)
    _s, topo, params = port_from_jax(jp)
    _CACHE[mode] = (jp, js, SimpleNamespace(spec=tspec, topo=topo, params=params), ts)
    return _CACHE[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_energy_and_frozen_split_match_jax(mode):
    import jax

    from membrane_solver_tpu.energy import get_module as jget
    from membrane_solver_tpu_torch.energy import get_module as tget

    jp, js, port, ts = case(mode)
    e_j, g_j = energy_and_grads(jp, NAME, js, port=False)
    e_t, g_t = energy_and_grads(port, NAME, ts, port=True)
    assert abs(e_t - e_j) <= REL * abs(e_j)
    assert np.max(np.abs(g_j[2])) > 0.0, "the term depends on the inner tilts"
    for f, gw, gt in zip(("positions", "tilts", "tilts_in", "tilts_out"), g_j, g_t):
        assert_close(gt, gw, REL, f, atol_scale=1e-300)
    pre, fn = jget(NAME).make_tilt_frozen(jp.spec)
    fr = pre(js, jp.topo, jp.params)
    ef_j, gf_j = jax.value_and_grad(lambda a: fn(a, js.tilts_out, fr, jp.topo, jp.params))(
        js.tilts_in)
    pre, fn = tget(NAME).make_tilt_frozen(port.spec)
    tin = ts.tilts_in.detach().clone().requires_grad_(True)
    ef = fn(tin, ts.tilts_out, pre(ts, port.topo, port.params), port.topo, port.params)
    (gf,) = torch.autograd.grad(ef, (tin,))
    assert abs(float(ef.detach()) - float(ef_j)) <= REL * abs(float(ef_j))
    assert_close(gf, np.asarray(gf_j)[:jp.n_vertices], REL, "frozen tilts_in")
    assert abs(float(ef.detach()) - e_t) <= REL * abs(e_t)


def _seeded_host(pkg, gp, seed=3):
    from membrane_solver_tpu.meshgen import build

    m = pkg.parse_geometry(build("kozlov_1disk"))
    m.global_parameters.update({**BENCH_GP, **gp})
    rng = np.random.default_rng(seed)
    for vid in sorted(m.vertices):
        v = m.vertices[vid]
        dz, tilt = 0.01 * rng.standard_normal(), 0.1 * rng.standard_normal(3)
        v.position[2] += dz
        v.tilt_in = tilt
    return m


@pytest.mark.parametrize("gp", [
    MODES["legacy"],
    {**MODES["on"], "tilt_thetaB_normal": None},
    {**MODES["legacy"], "tilt_thetaB_normal": [0.1, 0.0, 1.0], "tilt_thetaB_center": [0.05, 0, 0]},
], ids=["given_normal", "fitted_normal", "tilted_normal"])
def test_closed_form_update_matches_jax(gp):
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu.core.parameters import ParameterResolver
    from membrane_solver_tpu.energy import tilt_thetaB_contact_in as jmod
    from membrane_solver_tpu_torch.energy import tilt_thetaB_contact_in as tmod

    jm, tm = _seeded_host(jpkg, gp), _seeded_host(tpkg, gp)
    for m in (jm, tm):
        if gp.get("tilt_thetaB_normal", 0) is None:
            m.global_parameters.unset("tilt_thetaB_normal")
    assert jmod.scalar_update_live(jm, jm.global_parameters)
    assert tmod.scalar_update_live(tm, tm.global_parameters)
    before = tm.global_parameters.get("tilt_thetaB_value")
    jmod.update_scalar_params(jm, jm.global_parameters, ParameterResolver(jm.global_parameters))
    tmod.update_scalar_params(tm, tm.global_parameters)
    want = jm.global_parameters.get("tilt_thetaB_value")
    got = tm.global_parameters.get("tilt_thetaB_value")
    assert got != before
    assert abs(got - want) <= REL * abs(want), (got, want)


@pytest.mark.parametrize("gp,live", [
    ({}, False),
    ({"tilt_thetaB_contact_penalty_mode": "off"}, False),
    ({"tilt_thetaB_contact_penalty_mode": "1"}, True),
    ({"tilt_thetaB_contact_penalty_mode": "legacy", "tilt_thetaB_strength_in": 0.0}, False),
])
def test_scalar_update_live_matches_jax(gp, live):
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu.energy import tilt_thetaB_contact_in as jmod
    from membrane_solver_tpu_torch.energy import tilt_thetaB_contact_in as tmod

    jm, tm = _seeded_host(jpkg, gp), _seeded_host(tpkg, gp)
    assert jmod.scalar_update_live(jm, jm.global_parameters) is live
    assert tmod.scalar_update_live(tm, tm.global_parameters) is live


def test_minimize_updates_thetaB_each_iteration_without_recompiling():
    """One ``minimize(3)``: a host update before each iteration, each a closed-form step, no compile.

    Each update is the closed form on the host state it reads (the JAX
    package's values along the lane are held in the J0-fit test below).
    """
    from membrane_solver_tpu_torch.device import state as tstate
    from membrane_solver_tpu_torch.energy import tilt_thetaB_contact_in as tmod

    gp = {**BENCH_GP, **MODES["legacy"], "tilt_inner_steps": 6}
    tm = make_minimizer(True, gp=gp, dtype=torch.float64)
    seen, compiles, expected = [], [], []
    real = tmod.update_scalar_params

    def update(mesh, global_params):
        real(mesh, global_params)
        expected.append(global_params.get("tilt_thetaB_value"))

    def callback(_mesh, _i):
        seen.append(tm.global_params.get("tilt_thetaB_value"))
        compiles.append(tstate.COMPILES["compile_state"])

    tmod.update_scalar_params = update
    try:
        res = tm.minimize(3, callback=callback)
    finally:
        tmod.update_scalar_params = real
    compiles.append(tstate.COMPILES["compile_state"])
    assert res["iterations"] == 3 and len(seen) == 3 and len(expected) == 3
    assert len(set(expected)) == 3, "theta_B moves every iteration"
    assert seen[1:] == expected[:2] and tm.global_params.get("tilt_thetaB_value") == expected[2]
    assert compiles[-1] == compiles[0], compiles
    p = tm.problem()
    assert float(p.params["tilt_thetaB_value"]) == expected[2], "the parameters were refreshed"


def test_thetaB_optimize_skips_the_contact_update():
    """Under ``tilt_thetaB_optimize`` the scan owns theta_B: the contact module's update is skipped."""
    gp = {**BENCH_GP, **MODES["legacy"], "tilt_thetaB_optimize": True,
          "tilt_thetaB_optimize_every": 100}
    tm = make_minimizer(True, gp=gp, dtype=torch.float64)
    start = tm.global_params.get("tilt_thetaB_value")
    tm._update_scalar_params(tm._scalar_hooks())
    assert tm.global_params.get("tilt_thetaB_value") == start
    tm.global_params.set("tilt_thetaB_optimize", False)
    tm._update_scalar_params(tm._scalar_hooks())
    assert tm.global_params.get("tilt_thetaB_value") != start


def test_J0_fit_lane_steps_match_jax():
    """The J0-fit protocol at L0 through ``minimize(1)`` twice, step for step."""
    from chip_smoke import fit_deviation, pin_fit_record

    clean = J0_NOISE["clean"]
    gp = J0_FIT["global_parameters"]
    tm = make_minimizer(True, gp=gp, edits=J0_FIT, dtype=torch.float64)
    rel = 1e-10
    got_fits = []
    for k, (energy, accepted, theta) in enumerate(zip(clean["energies"], clean["accepted"],
                                                      clean["thetaB"], strict=True)):
        res = tm.minimize(1)
        assert res["step_success"] == accepted, f"step {k}"
        bound = max(rel, 2.0 * J0_NOISE["rel_spread_energies"][k])
        assert abs(res["energy"] - energy) <= bound * abs(energy), (k, res["energy"], energy)
        got_fits.append({"thetaB": float(tm.global_params.get("tilt_thetaB_value")),
                         **pin_fit_record(tm)})
        theta_bound = max(rel, 2.0 * J0_NOISE["rel_spread_thetaB"][k])
        assert abs(got_fits[k]["thetaB"] - theta) <= theta_bound * abs(theta)
        got_fits[k]["thetaB"] = clean["fits"][k]["thetaB"]  # held just above
    assert set(got_fits[0]) == {"thetaB", "circle_center", "circle_radius", "plane_offset"}
    assert fit_deviation(got_fits, clean["fits"]) <= rel
    assert clean["thetaB"][1] != clean["thetaB"][0]
