"""The card lane ``kozlov_L3_free_disk`` at L0: the port against the JAX package, float64.

The protocol of ``tests/fixtures/torch_port/kozlov_L3_free_disk_f64_jax.json``
(the kozlov lane with ``rigid_disk`` appended, no ``rigid_disk_group``, so
the 33 ``preset: disk`` vertices, and the disk's own ``pin_to_plane``
dropped; ``chip_smoke.lane_edits``) on meshgen ``kozlov_1disk`` without its
refinements: five ``minimize(1)`` step for step, with the JAX package's
accept flags and, per step, its multiplier-finite flag (every shape KKT
solve of the step gave finite multipliers: the branch that keeps the
projection), energies within rel 1e-10, the final positions and tilts
within rel 1e-10 or twice the JAX package's own spread under 1e-15 of
position noise (ROADMAP C3).  After every step the disk's anchor-pair
distances equal the reference shape's to 1e-9 of the disk radius.

The planar disk's pairwise rows span 2n - 3 of their 3n - 6 directions; on
this lane the port's LU left multipliers of 4e16 at the third step (a
round-off pivot in that null space) where the JAX package's LAPACK LU gave
53, and the residual check of ``jit_core.solve_kkt_with_rescue`` replaces
such a solution (the third step then agrees to 1e-13).
"""

from __future__ import annotations

import json

import numpy as np
import torch
from _torch_port_harness import FIXTURE, assert_steps, jax_noise_state, make_minimizer

from tools.record_torch_port_fixture import kkt_recorder, kozlov_free_disk_protocol

LANE_FIXTURE = FIXTURE.parent / "kozlov_L3_free_disk_f64_jax.json"
PROTOCOL = json.loads(LANE_FIXTURE.read_text())["protocol"]
REL = 1e-10


def test_fixture_protocol_is_the_recorders():
    assert PROTOCOL == json.loads(json.dumps(kozlov_free_disk_protocol()))
    assert PROTOCOL["extra_constraint_modules"] == ["rigid_disk"]
    assert PROTOCOL["free_disk_preset"] == "disk"


def lane(port: bool, **kw):
    return make_minimizer(port, gp=PROTOCOL["global_parameters"], edits=PROTOCOL, **kw)


def pair_distance_error(mn) -> float:
    """Largest |d_ij - d_ij(reference)| over the rigid disk's anchor pairs, on the device state."""
    p = mn.problem()
    x = lambda k: p.topo.extras[f"constraint:rigid_disk/{k}"]  # noqa: E731
    pairs = x("pairs")
    pos = p.state.positions[x("rows")]
    ref = x("ref")
    d = torch.linalg.vector_norm(pos[pairs[:, 0]] - pos[pairs[:, 1]], dim=1)
    d_ref = torch.linalg.vector_norm(ref[pairs[:, 0]] - ref[pairs[:, 1]], dim=1)
    return float(torch.max(torch.abs(d - d_ref)))


def test_free_disk_protocol_matches_jax_at_L0():
    from membrane_solver_tpu.runtime import jit_core as jcore
    from membrane_solver_tpu_torch.runtime import jit_core as tcore

    original = jcore._solve_kkt_with_rescue
    try:
        solves = kkt_recorder()
        jm = lane(False)
        tm = lane(True, dtype=torch.float64)
        assert tm.problem().topo.extras["constraint:rigid_disk/rows"].shape[0] == 33
        steps, flags = [], []
        for _ in range(PROTOCOL["steps"]):
            first = len(solves)
            tcore.KKT_RECORD = []
            jr = jm.minimize(1)
            import jax

            jax.effects_barrier()
            tr = tm.minimize(1)
            assert len(solves) > first and tcore.KKT_RECORD
            flags.append((all(f for f, _m in solves[first:]),
                          all(bool(f) for f, _r, _m in tcore.KKT_RECORD)))
            steps.append((jr, tr))
            assert pair_distance_error(tm) <= 1e-9 * 1.0
    finally:
        jcore._solve_kkt_with_rescue = original
        tcore.KKT_RECORD = None
    assert [a for a, _b in flags] == [b for _a, b in flags]
    noisy = jax_noise_state(PROTOCOL["global_parameters"], PROTOCOL["steps"], edits=PROTOCOL)
    assert_steps(steps, jm, tm, REL, noisy=noisy)
    assert any(r["step_success"] for _j, r in steps)
    assert np.isfinite([r["energy"] for _j, r in steps]).all()
