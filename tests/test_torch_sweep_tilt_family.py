"""The family lane of ``tests/test_torch_sweep_tilt.py`` against the JAX package's sweep.

Kozlov L0 with phase 20's and phase 21's set-ups and seeded heights and
tilts (``test_torch_sweep_tilt._family``): the ten drives,
``tilt_coupling``, ``rim_slope_match_out``, ``bending_tilt`` and
``mean_curvature_tilt`` beside the lane's six energies, the two tilt-match
constraints beside its four; three members, two steps at 1e-3 of
``run_sweep`` with ``enforce_in_line_search`` in both packages: per member
the stats and the final positions and tilts at rel 1e-10, equal flags and
iterations.  Apart from the rest of that file because JAX traces and
compiles this lane's vmapped block for about 45 s on the CPU.
"""

from __future__ import annotations

import numpy as np

from tests.test_torch_sweep_tilt import (
    ENFORCE,
    REL,
    STEP_SIZE,
    STEPS,
    _minimizer,
    assert_members_close,
    members,
    port_run,
)


def test_family_sweep_matches_jax_per_member():
    from membrane_solver_tpu.parallel.sweep import run_sweep
    from membrane_solver_tpu.runtime.jit_core import MinimizeOptions

    tp = _minimizer("family", True).problem()
    jp = _minimizer("family", False).problem()
    got = port_run(tp, "family", ENFORCE)
    params, positions = members("family", jp.params, np.asarray(jp.state.positions))
    want = run_sweep(jp, params, STEPS, step_size=STEP_SIZE, options=MinimizeOptions(**ENFORCE),
                     member_positions=positions)
    assert_members_close(got, want, tp.n_vertices, REL)
    stats = got[2]
    assert np.asarray(stats.iterations).tolist() == [STEPS] * 3
    assert int(np.sum(np.asarray(stats.accepted_steps))) > 0
