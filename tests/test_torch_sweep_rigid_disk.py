"""``rigid_disk`` in the parameter sweep (``parallel/sweep``) against the JAX package's.

The lane of ``tests/fixtures/torch_port/kozlov_L3_free_disk_sweep_f64_jax.json``
(the kozlov protocol with ``rigid_disk`` appended and the disk's own
``pin_to_plane`` dropped, ``chip_smoke.lane_edits``) at L0: its five
``minimize(1)`` in each package, then the fixture's sweep protocol (four
members scanning ``tilt_modulus_in`` and theta_B, positions dilated by
1e-3 m), three steps at 1e-3 of ``run_sweep`` in both packages.  Per
member the stats and the final positions and tilts at rel 1e-10, equal
flags and iterations; per member and iteration the shape KKT solve's
multiplier-finite flag equal to the JAX package's (its vmapped block
reports each member's solve, ``record_torch_port_fixture.kkt_recorder``),
and the port's null-space fallback (``jit_core.solve_kkt_with_rescue``,
which JAX's solve does not have) equal to each member's one-member sweep;
member m against a one-member sweep of member m in bits; the rigid fit
mapped over the members' final states restores every disk's anchor-pair
distances to 1e-9 of the disk radius, each member's the bits of its own
fit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_sweep_interface import (
    FIELDS,
    REL,
    _fixture,
    assert_member_bits,
    assert_members_close,
    lane_problem,
    sweep,
)

PAIR_TOL = 1e-9


@pytest.fixture(scope="module")
def free_disk_lane():
    from membrane_solver_tpu_torch.runtime import jit_core

    protocol = _fixture("kozlov_L3_free_disk_sweep_f64_jax.json")["protocol"]
    problem = lane_problem(True, protocol)
    jit_core.KKT_RECORD = []
    try:
        got = sweep(problem, protocol, True)
        solves = [tuple(t.clone() for t in s) for s in jit_core.KKT_RECORD]
    finally:
        jit_core.KKT_RECORD = None
    return protocol, problem, got, solves


def per_member(solves, k: int, B: int) -> list:
    """Per member, the ``k``-th field of every recorded solve."""
    return [[bool(s[k][m]) for s in solves] for m in range(B)]


def test_free_disk_sweep_matches_jax_per_member(free_disk_lane):
    import jax

    from membrane_solver_tpu.runtime import jit_core as jcore
    from tools.record_torch_port_fixture import kkt_recorder

    protocol, tp, got, solves = free_disk_lane
    B = protocol["members"]
    original = jcore._solve_kkt_with_rescue
    jp = lane_problem(False, protocol)
    # the recorder reaches only blocks traced after it, and the blocks traced with it must
    # not be reused once it is gone: JAX's caches are cleared on both sides
    jax.clear_caches()
    try:
        recorded = kkt_recorder()
        want = sweep(jp, protocol, False)
        jax.effects_barrier()
    finally:
        jcore._solve_kkt_with_rescue = original
        jax.clear_caches()
    assert_members_close(got, want, tp.n_vertices, REL)
    jax_finite = np.array([f for f, _m in recorded], dtype=bool).reshape(-1, B).T.tolist()
    assert solves and per_member(solves, 0, B) == jax_finite
    assert np.asarray(got[2].iterations).tolist() == [protocol["steps"]] * B


def test_member_equals_its_one_member_sweep_in_bits(free_disk_lane):
    protocol, tp, got, solves = free_disk_lane
    assert_member_bits(got, tp, protocol)


def test_fallback_flags_are_each_members_own(free_disk_lane):
    """The null-space fallback is chosen per member on the device: member m's flags are those
    of its one-member sweep."""
    from membrane_solver_tpu_torch.runtime import jit_core

    protocol, tp, _got, solves = free_disk_lane
    B = protocol["members"]
    for m in range(B):
        jit_core.KKT_RECORD = []
        try:
            sweep(tp, protocol, True, pick=m)
            one = [tuple(t.clone() for t in s) for s in jit_core.KKT_RECORD]
        finally:
            jit_core.KKT_RECORD = None
        assert [bool(s[0][0]) for s in one] == per_member(solves, 0, B)[m]
        assert [bool(s[1][0]) for s in one] == per_member(solves, 1, B)[m]
        assert [float(s[2][0]) for s in one] == [float(s[2][m]) for s in solves]


def test_rigid_enforcement_per_member(free_disk_lane):
    """The default options enforce nothing in the line search, so the dilated members keep
    their dilated disks; the rigid fit mapped over the members' final states puts every disk
    back on the reference shape (anchor-pair distances within 1e-9 of the disk radius)."""
    from torch.func import vmap

    from chip_smoke import member_pair_errors
    from membrane_solver_tpu_torch.constraints import get_constraint

    protocol, tp, got, _solves = free_disk_lane
    enforce = get_constraint("rigid_disk").make_enforce(tp.spec)
    before = member_pair_errors(torch, got[0], tp.topo)
    assert min(before[1:]) > 1e-6  # members 1.. start dilated
    with torch.no_grad():
        fitted = vmap(lambda st: enforce(st, tp.topo, tp.params))(got[0])
    assert max(member_pair_errors(torch, fitted, tp.topo)) <= PAIR_TOL
    for m in range(protocol["members"]):
        st = type(tp.state)(*(getattr(got[0], f)[m] for f in FIELDS))
        one = enforce(st, tp.topo, tp.params)
        assert torch.equal(one.positions, fitted.positions[m]), f"member {m}"
