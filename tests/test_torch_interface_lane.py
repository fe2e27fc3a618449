"""The card lane ``kozlov_L3_interface`` at L0: the port against the JAX package, float64.

The protocol of ``tests/fixtures/torch_port/kozlov_L3_interface_f64_jax.json``
(the kozlov lane with ``rim_slope_match_out`` taken out of the constraint
modules, ``curved_local_interface_hard`` put in its place and the
``curved_local_interface_law`` energy at strength 0.8; ``chip_smoke.lane_edits``)
on meshgen ``kozlov_1disk`` without its refinements: five ``minimize(1)``
step for step, with the JAX package's accept flags and energies within rel
1e-10, the final positions and tilts within rel 1e-10 or twice the JAX
package's own spread under 1e-15 of position noise (ROADMAP C3), and the
breakdown's law term within rel 1e-10, floored at 1e-12 of the lane's
energy.  The relax projects every module's tilt rows densely (the hard
constraint's row has no compact form).  The fixture's ``protocol`` block must
be the recorder's ``kozlov_interface_protocol()``.
"""

from __future__ import annotations

import json

import torch
from _torch_port_harness import FIXTURE, assert_steps, jax_noise_state, make_minimizer, steps_of

from tools.record_torch_port_fixture import kozlov_interface_protocol

LANE_FIXTURE = FIXTURE.parent / "kozlov_L3_interface_f64_jax.json"
PROTOCOL = json.loads(LANE_FIXTURE.read_text())["protocol"]
REL = 1e-10


def test_fixture_protocol_is_the_recorders():
    assert PROTOCOL == json.loads(json.dumps(kozlov_interface_protocol()))
    assert PROTOCOL["extra_constraint_modules"] == ["curved_local_interface_hard"]
    assert PROTOCOL["drop_constraint_modules"] == ["rim_slope_match_out"]


def lane(port: bool, **kw):
    return make_minimizer(port, gp=PROTOCOL["global_parameters"], edits=PROTOCOL, **kw)


def test_interface_protocol_matches_jax_at_L0():
    from membrane_solver_tpu_torch.runtime import tilt_relax

    jm = lane(False)
    tm = lane(True, dtype=torch.float64)
    spec = tm.problem().spec
    assert "rim_slope_match_out" not in spec.constraint_modules
    assert tilt_relax.make_compact_tilt_collector(spec) is None  # the dense tilt rows
    steps = steps_of(jm, tm, PROTOCOL["steps"])
    noisy = jax_noise_state(PROTOCOL["global_parameters"], PROTOCOL["steps"], edits=PROTOCOL)
    assert_steps(steps, jm, tm, REL, noisy=noisy)
    assert any(r["step_success"] for _j, r in steps)
    want = float(jm.compute_energy_breakdown()["curved_local_interface_law"])
    got = float(tm.compute_energy_breakdown()["curved_local_interface_law"])
    floor = 1e-12 * abs(float(jm.compute_energy()))
    assert abs(got - want) <= REL * max(abs(want), floor)
