"""The theta_B scan under the reduced-energy line search: the port against the JAX package.

float64, meshgen ``kozlov_1disk`` at L0 with the option tests' parameters
(``_torch_port_harness.OPTION_GP``), the reduced line search on and the
scan of ``tests/test_inloop_relax_semantics.py`` every iteration: two
``minimize(1)`` (relax -> scan -> step), the JAX package's selected
theta_B at every scan, energies within rel 1e-10 and the final state
within twice the JAX package's own spread under 1e-15 of position noise
(``_torch_port_harness.assert_steps``).
"""

from __future__ import annotations

import torch
from _torch_port_harness import OPTION_GP, assert_steps, jax_noise_state, make_minimizer, steps_of

REL = 1e-10


def test_thetaB_scan_under_the_reduced_line_search():
    """relax -> scan -> step with the reduced line search: JAX's selected theta_B and trajectory."""
    gp = {**OPTION_GP, "line_search_reduced_energy": "on", "tilt_thetaB_optimize": True,
          "tilt_thetaB_optimize_every": 1, "tilt_thetaB_optimize_delta": 0.01,
          "tilt_thetaB_optimize_inner_steps": 4, "tilt_thetaB_value": 0.05}
    jm = make_minimizer(False, gp=gp)
    tm = make_minimizer(True, gp=gp, dtype=torch.float64)
    steps = steps_of(jm, tm, 2)
    assert_steps(steps, jm, tm, REL, noisy=jax_noise_state(gp, 2))
    assert ([r["selected_thetaB"] for r in tm.mesh._thetaB_scan_trace]
            == [r["selected_thetaB"] for r in jm.mesh._thetaB_scan_trace])
