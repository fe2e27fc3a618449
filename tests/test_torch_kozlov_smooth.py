"""The card lane ``kozlov_L3_smooth`` at L0: the port against the JAX package, float64.

The protocol of ``tests/fixtures/torch_port/kozlov_L3_smooth_f64_jax.json``
(the kozlov lane with ``tilt_smoothness_in`` and ``tilt_smoothness_out``
added to its energy modules) on meshgen ``kozlov_1disk`` without its
refinements (177 vertices, where the shape steps are accepted and both
leaflets' smoothness is above round-off): five ``minimize(1)`` step for
step, with the JAX package's accept flags and energies within rel 1e-10,
the final positions and tilts, and the breakdown's two smoothness terms,
within rel 1e-10 or twice the JAX package's own spread under 1e-15 of
position noise, whichever is larger (ROADMAP C3: the relax amplifies
round-off; the outer leaflet's smoothness, 1.1e-8 here, moves by 7.7e-18
between the packages).  The fixture's ``protocol`` block must
be the recorder's ``kozlov_smooth_protocol()``, so the card and the
fixture run one protocol.
"""

from __future__ import annotations

import json

import torch
from _torch_port_harness import FIXTURE, assert_steps, jax_noise_state, make_minimizer, steps_of

from tools.record_torch_port_fixture import kozlov_smooth_protocol

SMOOTH_FIXTURE = FIXTURE.parent / "kozlov_L3_smooth_f64_jax.json"
PROTOCOL = json.loads(SMOOTH_FIXTURE.read_text())["protocol"]
REL = 1e-10


def test_fixture_protocol_is_the_recorders():
    assert PROTOCOL == json.loads(json.dumps(kozlov_smooth_protocol()))
    assert PROTOCOL["extra_energy_modules"] == ["tilt_smoothness_in", "tilt_smoothness_out"]


def test_smooth_protocol_matches_jax_at_L0():
    gp, modules = PROTOCOL["global_parameters"], PROTOCOL["extra_energy_modules"]
    jm = make_minimizer(False, gp=gp, modules=modules)
    tm = make_minimizer(True, gp=gp, modules=modules, dtype=torch.float64)
    steps = steps_of(jm, tm, PROTOCOL["steps"])
    noisy = jax_noise_state(gp, PROTOCOL["steps"], modules=modules)
    assert_steps(steps, jm, tm, REL, noisy=noisy)
    assert any(r["step_success"] for _j, r in steps)
    want = {k: float(v) for k, v in jm.compute_energy_breakdown().items()}
    got = {k: float(v) for k, v in tm.compute_energy_breakdown().items()}
    for name in modules:
        assert want[name] > 1e-12, name
        bound = max(REL * want[name], 2.0 * abs(noisy["breakdown"][name] - want[name]))
        assert abs(got[name] - want[name]) <= bound, name
