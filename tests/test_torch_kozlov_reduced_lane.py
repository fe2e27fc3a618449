"""The card lane ``kozlov_L3_reduced`` at L0: the port against the JAX package, float64.

The protocol of ``tests/fixtures/torch_port/kozlov_L3_reduced_f64_jax.json``
(the bench parameters, ``line_search_reduced_energy`` on, shared-rim
staggered matching) on meshgen ``kozlov_1disk`` without its refinements
(177 vertices): five ``minimize(1)`` step for step, with the JAX package's
accept flags, energies within rel 1e-10, and the final positions and tilts
within twice the JAX package's own spread under 1e-15 of position noise
(its 40-step relax works at the float64 floor, ROADMAP C3).
"""

from __future__ import annotations

import json

import torch
from _torch_port_harness import FIXTURE, assert_steps, jax_noise_state, make_minimizer, steps_of

REDUCED_FIXTURE = FIXTURE.parent / "kozlov_L3_reduced_f64_jax.json"
REL = 1e-10


def test_reduced_protocol_matches_jax_at_L0():
    """The card lane's protocol (kozlov_L3_reduced's fixture) at L0, five steps, step for step."""
    protocol = json.loads(REDUCED_FIXTURE.read_text())["protocol"]
    gp = protocol["global_parameters"]
    assert gp["line_search_reduced_energy"] == "on"
    jm = make_minimizer(False, gp=gp)
    tm = make_minimizer(True, gp=gp, dtype=torch.float64)
    steps = steps_of(jm, tm, protocol["steps"])
    assert_steps(steps, jm, tm, REL, noisy=jax_noise_state(gp, protocol["steps"]))
    assert all(r["line_search_trials"] > 0 for _j, r in steps)
