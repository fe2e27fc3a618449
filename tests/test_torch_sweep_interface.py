"""The local-interface family in the parameter sweep (``parallel/sweep``) against the JAX package's.

The lane of ``tests/fixtures/torch_port/kozlov_L3_interface_sweep_f64_jax.json``
(the kozlov protocol with ``rim_slope_match_out`` replaced by the hard
``curved_local_interface_hard`` and the ``curved_local_interface_law``
energy) at L0: its five ``minimize(1)`` in each package, then, from the
state they leave, the fixture's sweep protocol (``chip_smoke.sweep_members``:
four members scanning ``tilt_modulus_in``, theta_B and the law's strength,
positions dilated by 1e-3 m), three steps at 1e-3 of ``run_sweep`` in both
packages (JAX's vmapped block).  Per member the stats and the final
positions and tilts at rel 1e-10, equal flags and iterations; member m
against a one-member sweep of member m in bits.

The interface family and the rigid disk mapped over members
(``chip_smoke.interface_items``, card phase 46's items) on that phase's
set-up at L0 (``chip_smoke.interface_drives_setup``: phase 25's match
drives with the law and the hard constraint added) and four seeded
members: each item against the JAX package's ``jax.vmap``
(``tools/record_torch_port_fixture.sweep_interface_arrays`` at L0) at rel
1e-12 of its largest entry, and member m equal in bits to its single call.
The constraints' repeated rows add in levels (``state.ordered_index_add``),
built before the map (``member_block.prime_ordered_levels``): a level's
``index_add`` under ``vmap`` adds one value per (member, row), in the
single call's order.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import types

import numpy as np
import pytest
import torch
from torch.func import vmap

from tests._torch_port_harness import make_minimizer, to_np

FIXTURES = "tests/fixtures/torch_port/"
REL = 1e-10
ITEM_REL = 1e-12
STATS = ("energy", "accepted_energy", "grad_norm", "step_size")
FLAGS = ("step_success", "iterations", "converged", "terminated_early", "zero_step_counter")
FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")
# the items of each module (``chip_smoke.interface_items``' keys)
MODULE_ITEMS = {
    "curved_local_interface_law": "energy/curved_local_interface_law",
    "curved_local_interface_penalty": "energy/curved_local_interface_penalty",
    "curved_local_interface_hard": "constraint/curved_local_interface_hard/-/",
    "curved_local_interface_match-vector_average":
        "constraint/curved_local_interface_match/vector_average/",
    "curved_local_interface_match-local_mixed_match_v1":
        "constraint/curved_local_interface_match/local_mixed_match_v1/",
    "rigid_disk": "constraint/rigid_disk/-/",
}


def _fixture(name: str) -> dict:
    with open(FIXTURES + name) as fh:
        return json.load(fh)


def lane_problem(port: bool, protocol: dict):
    """The sweep protocol's lane at L0 after its steps (and the protocol's
    ``chip_smoke.uneven_disk`` offsets): either package's compiled problem."""
    lane = protocol["kozlov"]
    kw = {"dtype": torch.float64} if port else {}
    mn = make_minimizer(port, gp=lane["global_parameters"], edits=lane, **kw)
    for _ in range(lane["steps"]):
        mn.minimize(1)
    from chip_smoke import uneven_disk

    uneven_disk(mn, protocol)
    return mn.problem()


def sweep(problem, protocol: dict, port: bool, pick=None):
    """``run_sweep`` of the protocol's members on either package's problem."""
    from chip_smoke import sweep_members

    if port:
        from membrane_solver_tpu_torch.parallel.sweep import run_sweep

        positions = problem.state.positions.numpy()
    else:
        from membrane_solver_tpu.parallel.sweep import run_sweep

        positions = np.asarray(problem.state.positions)
    params, pos = sweep_members(protocol, positions, problem.params)
    if pick is not None:
        params, pos = params[pick:pick + 1], pos[pick:pick + 1]
    return run_sweep(problem, params, protocol["steps"], step_size=protocol["step_size"],
                     member_positions=pos)


def assert_members_close(got, want, n: int, rel: float) -> None:
    (g_states, _g, g_stats), (w_states, _w, w_stats) = got, want
    for key in STATS:
        g, w = to_np(np.asarray(getattr(g_stats, key))), to_np(np.asarray(getattr(w_stats, key)))
        assert np.all(np.abs(g - w) <= rel * np.abs(w)), f"{key}: {g} vs {w}"
    for key in FLAGS:
        g, w = np.asarray(getattr(g_stats, key)), np.asarray(getattr(w_stats, key))
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), f"{key}: {g} vs {w}"
    for f in FIELDS:
        g, w = to_np(getattr(g_states, f))[:, :n], to_np(getattr(w_states, f))[:, :n]
        for m in range(w.shape[0]):
            scale = max(float(np.max(np.abs(w[m]))), 1.0)
            err = float(np.max(np.abs(g[m] - w[m])))
            assert err <= rel * scale, f"{f} member {m}: {err:.3e} > {rel:.0e} * {scale:.3e}"


def assert_member_bits(batched, problem, protocol, port_sweep=sweep) -> None:
    """Member m of ``batched`` against a one-member sweep of member m, in bits."""
    states, _ss, stats = batched
    for m in range(protocol["members"]):
        one, _s, one_stats = port_sweep(problem, protocol, True, pick=m)
        for f in FIELDS:
            assert torch.equal(getattr(one, f)[0], getattr(states, f)[m]), f"{f} member {m}"
        for key in STATS + FLAGS:
            assert np.array_equal(np.asarray(getattr(one_stats, key))[0],
                                  np.asarray(getattr(stats, key))[m]), f"{key} member {m}"


@pytest.fixture(scope="module")
def interface_lane():
    protocol = _fixture("kozlov_L3_interface_sweep_f64_jax.json")["protocol"]
    problem = lane_problem(True, protocol)
    return protocol, problem, sweep(problem, protocol, True)


def test_fixture_protocols_are_the_recorders():
    from tools.record_torch_port_fixture import (
        kozlov_free_disk_sweep_protocol,
        kozlov_interface_sweep_protocol,
        kozlov_sweep_interface_drives_protocol,
    )

    for name, recorder in (("kozlov_L3_interface_sweep_f64_jax.json",
                            kozlov_interface_sweep_protocol),
                           ("kozlov_L3_free_disk_sweep_f64_jax.json",
                            kozlov_free_disk_sweep_protocol),
                           ("kozlov_L3_sweep_interface_drives_f64_jax.json",
                            kozlov_sweep_interface_drives_protocol)):
        assert _fixture(name)["protocol"] == json.loads(json.dumps(recorder())), name


def test_interface_sweep_matches_jax_per_member(interface_lane):
    protocol, tp, got = interface_lane
    jp = lane_problem(False, protocol)
    want = sweep(jp, protocol, False)
    assert_members_close(got, want, tp.n_vertices, REL)
    stats = got[2]
    assert np.asarray(stats.iterations).tolist() == [protocol["steps"]] * protocol["members"]
    energies = np.asarray(stats.energy)
    assert len(np.unique(np.round(energies, 9))) == len(energies)


def test_member_equals_its_one_member_sweep_in_bits(interface_lane):
    protocol, tp, got = interface_lane
    assert_member_bits(got, tp, protocol)


def test_levels_are_built_before_the_map(interface_lane, monkeypatch):
    """The ordered rows' levels come from ``member_block.prime_ordered_levels`` before any map:
    a level built inside the map (through ``state.occurrence_levels``) would fail here."""
    from membrane_solver_tpu_torch.device import state as tstate
    from membrane_solver_tpu_torch.parallel import member_block

    protocol, tp, got = interface_lane
    topo = dataclasses.replace(tp.topo)  # no kept levels
    assert "_kept" not in topo.__dict__
    built = []

    def inside(rows):
        raise AssertionError("occurrence levels built inside the map")

    def prime(rows, _levels=tstate.occurrence_levels):
        built.append(int(rows.numel()))
        return _levels(rows)

    monkeypatch.setattr(tstate, "occurrence_levels", inside)
    monkeypatch.setattr(member_block, "occurrence_levels", prime)
    again = sweep(dataclasses.replace(tp, topo=topo), protocol, True)
    assert built
    for f in FIELDS:
        assert torch.equal(getattr(again[0], f), getattr(got[0], f)), f


def test_ordered_index_add_maps_per_member():
    """Repeated rows add one level at a time; under vmap member m's sums are its single call's
    bits and the left-to-right order of the list."""
    from membrane_solver_tpu_torch.device.state import occurrence_levels, ordered_index_add

    kept = {}
    topo = types.SimpleNamespace(kept=lambda key, make: kept.setdefault(key, make()))
    rows = torch.tensor([3, 1, 3, 3, 0, 1, 5])
    topo.kept(("ordered_index_add", "k"), lambda: occurrence_levels(rows))
    assert len(kept[("ordered_index_add", "k")]) == 3
    rng = np.random.default_rng(7)
    target = torch.as_tensor(rng.standard_normal((4, 6, 3)))
    values = torch.as_tensor(rng.standard_normal((4, 7, 3)) * 10.0 ** rng.integers(-8, 8, (4, 7, 1)))
    got = vmap(lambda t, v: ordered_index_add(topo, "k", t, rows, v))(target, values)
    for m in range(4):
        one = ordered_index_add(topo, "k", target[m], rows, values[m])
        assert torch.equal(got[m], one)
        seq = target[m].clone()
        for i, r in enumerate(rows.tolist()):
            seq[r] = seq[r] + values[m, i]
        assert torch.equal(one, seq)


# ----------------------------------------------------------------------
# the family and the rigid disk mapped over members, against jax.vmap
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def interface_items_pair():
    """(JAX's arrays and vmapped-vs-single deviations, the port's items) at L0."""
    import chip_smoke
    from chip_smoke import (TILT_FIELDS, interface_drives_setup, interface_items,
                            interface_problems, tilt_member_inputs)
    from membrane_solver_tpu_torch import Minimizer
    from tools.record_torch_port_fixture import (
        kozlov_sweep_interface_drives_protocol,
        sweep_interface_arrays,
    )

    protocol = kozlov_sweep_interface_drives_protocol()
    want = sweep_interface_arrays(refines=0)
    mesh = make_minimizer(True, dtype=torch.float64).mesh
    interface_drives_setup(mesh, protocol)
    problems = interface_problems(Minimizer, mesh, protocol, device="cpu", dtype=torch.float64)
    p = problems[None]
    base = {f: getattr(p.state, f).numpy().astype(np.float64) for f in TILT_FIELDS}
    saved, chip_smoke.DEVICE = chip_smoke.DEVICE, "cpu"
    try:
        got = interface_items(torch, problems, protocol, tilt_member_inputs(protocol, base))
    finally:
        chip_smoke.DEVICE = saved
    return want, got


def assert_module_items(key: str) -> None:
    """Every item of one module: the port's map against JAX's (rel ``ITEM_REL`` of the
    largest entry) and each member against its single call, in bits."""
    from chip_smoke import relative_error

    want, got = interface_items_pair()
    items = [k for k in got["vmapped"] if k == key or k.startswith(key + ("" if key.endswith("/")
                                                                          else "/"))]
    assert items, key
    assert any(np.max(np.abs(np.asarray(want["arrays"][i]))) > 0.0 for i in items), key
    for item in items:
        g = np.asarray(got["vmapped"][item])
        w = np.asarray(want["arrays"][item])
        assert g.shape == w.shape, item
        assert relative_error(g, w) <= ITEM_REL, f"{item}: {relative_error(g, w):.3e}"
        for m, one in enumerate(got["single"][item]):
            assert np.array_equal(g[m], one), f"{item} member {m}"


@pytest.mark.parametrize("module", list(MODULE_ITEMS))
def test_module_matches_jax_vmap_and_its_single_calls(module):
    assert_module_items(MODULE_ITEMS[module])
