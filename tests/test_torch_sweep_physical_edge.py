"""The physical-edge rim placement in the parameter sweep (``parallel/sweep``) against the JAX package's.

The lane of ``tests/fixtures/torch_port/kozlov_L3_physical_edge_sweep_f64_jax.json``
(the kozlov protocol with ``rim_slope_match_mode`` ``physical_edge_staggered_v1``:
the disk group matched to its nearest-azimuth rows of the first free
shell, several conditions per shell row, in levels) at L0: the lane's five
``minimize(1)`` run in the JAX package, and the state they leave starts
both packages' sweeps (at L0 the lanes' relax amplifies round-off to
~1e-3 in a step, ROADMAP C3, and ``tests/test_torch_scaffold_trace.py``
holds the port's own lane steps within that spread).  The fixture's sweep
protocol (``chip_smoke.sweep_members``: four members scanning
``tilt_modulus_in`` and theta_B, positions dilated by 1e-3 m) then runs
three steps at 1e-3 of ``run_sweep`` in both packages, with the
enforcement in every line-search trial (``enforce_in_line_search``, as the
lane's own minimize enforces).  Per member the stats and the final
positions and tilts at rel 1e-10, equal flags and iterations; member m
against a one-member sweep of member m in bits; the condition levels built
once per topology, before any map.

The rim placement's items mapped over members on the plain lane
(``chip_smoke.physical_edge_items``, card phase 52's: the compact tilt and
shape rows, the tilt enforcement) on four seeded members about the lane's
compiled start: against the JAX package's ``jax.vmap``
(``tools/record_torch_port_fixture.sweep_physical_edge_arrays`` at L0) at
rel 1e-12 of the largest entry, and member m equal in bits to its single
call.  ``tests/test_torch_sweep_scaffold.py`` holds the scaffold-trace lane
the same way, with its ``trace_z`` fallback.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from tests._torch_port_harness import make_minimizer
from tests.test_torch_sweep_interface import FIELDS, assert_member_bits, assert_members_close

FIXTURES = "tests/fixtures/torch_port/"
SWEEP = "kozlov_L3_physical_edge_sweep_f64_jax.json"
DRIVES = "kozlov_L3_sweep_physical_edge_drives_f64_jax.json"
REL = 1e-10
ITEM_REL = 1e-12
ITEMS = ("tilt_rows", "shape_rows", "tilts_in", "tilts_out", "enforce/positions",
         "enforce/tilts_out")


def fixture(name: str) -> dict:
    with open(FIXTURES + name) as fh:
        return json.load(fh)


def lane_pair(protocol: dict):
    """(JAX problem, port problem) at L0, both compiled from the host mesh the JAX lane's
    protocol steps leave (written into the port's minimizer of the same lane)."""
    lane = protocol["kozlov"]
    jm = make_minimizer(False, gp=lane["global_parameters"], edits=lane)
    for _ in range(lane["steps"]):
        jm.minimize(1)
    jm._sync_host()
    jm.invalidate()
    tm = make_minimizer(True, gp=lane["global_parameters"], edits=lane, dtype=torch.float64)
    for vid, v in jm.mesh.vertices.items():
        target = tm.mesh.vertices[vid]
        for f in ("position", "tilt", "tilt_in", "tilt_out"):
            getattr(target, f)[:] = getattr(v, f)
    tm.invalidate()
    return jm.problem(), tm.problem()


def sweep(problem, protocol: dict, port: bool, pick=None):
    """``run_sweep`` of the protocol's members under its options on either package's problem."""
    from chip_smoke import sweep_members, sweep_options

    if port:
        from membrane_solver_tpu_torch.parallel.sweep import run_sweep
        from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

        positions = problem.state.positions.numpy()
    else:
        from membrane_solver_tpu.parallel.sweep import run_sweep
        from membrane_solver_tpu.runtime.jit_core import MinimizeOptions

        positions = np.asarray(problem.state.positions)
    params, pos = sweep_members(protocol, positions, problem.params)
    if pick is not None:
        params, pos = params[pick:pick + 1], pos[pick:pick + 1]
    return run_sweep(problem, params, protocol["steps"], step_size=protocol["step_size"],
                     options=MinimizeOptions(**sweep_options(protocol)), member_positions=pos)


def assert_levels_built_before_the_map(problem, protocol: dict, got, monkeypatch) -> None:
    """A sweep on a copy of the topology (no kept levels) builds each ordered key's levels once,
    in ``member_block.prime_ordered_levels``: a level built anywhere else (``state``'s
    ``ordered_index_add`` or the rim's condition levels, inside the map) fails; the result is
    the first sweep's, bit for bit."""
    from membrane_solver_tpu_torch.constraints import rim_slope_match_out as rim
    from membrane_solver_tpu_torch.device import state as tstate
    from membrane_solver_tpu_torch.parallel import member_block

    topo = dataclasses.replace(problem.topo)
    assert "_kept" not in topo.__dict__
    built = []

    def inside(rows):
        raise AssertionError("occurrence levels built inside the map")

    def prime(rows, _levels=tstate.occurrence_levels):
        built.append(int(rows.numel()))
        return _levels(rows)

    monkeypatch.setattr(tstate, "occurrence_levels", inside)
    monkeypatch.setattr(rim, "occurrence_levels", inside)
    monkeypatch.setattr(member_block, "occurrence_levels", prime)
    again = sweep(dataclasses.replace(problem, topo=topo), protocol, True)
    outer = topo.extras["constraint:rim_slope_match_out/outer"]
    assert built == [int(outer.numel())]
    assert len(topo.kept(("ordered_index_add", "constraint:rim_slope_match_out/outer"),
                         lambda: None)) > 1  # shared shell rows: several levels
    for f in FIELDS:
        assert torch.equal(getattr(again[0], f), getattr(got[0], f)), f


@pytest.fixture(scope="module")
def physical_edge_lane():
    protocol = fixture(SWEEP)["protocol"]
    jp, tp = lane_pair(protocol)
    return protocol, jp, tp, sweep(tp, protocol, True)


def test_fixture_protocols_are_the_recorders():
    from tools.record_torch_port_fixture import (
        kozlov_physical_edge_sweep_protocol,
        kozlov_scaffold_sweep_protocol,
        kozlov_sweep_physical_edge_drives_protocol,
    )

    for name, recorder in ((SWEEP, kozlov_physical_edge_sweep_protocol),
                           ("kozlov_L3_scaffold_sweep_f64_jax.json",
                            kozlov_scaffold_sweep_protocol),
                           (DRIVES, kozlov_sweep_physical_edge_drives_protocol)):
        assert fixture(name)["protocol"] == json.loads(json.dumps(recorder())), name


def test_physical_edge_sweep_matches_jax_per_member(physical_edge_lane):
    protocol, jp, tp, got = physical_edge_lane
    want = sweep(jp, protocol, False)
    assert_members_close(got, want, tp.n_vertices, REL)
    stats = got[2]
    assert np.asarray(stats.iterations).tolist() == [protocol["steps"]] * protocol["members"]
    assert np.asarray(stats.trials).sum() > 0  # the enforcement ran in scored trials
    assert np.asarray(stats.trace_z_fallbacks).tolist() == [0] * protocol["members"]


def test_member_equals_its_one_member_sweep_in_bits(physical_edge_lane):
    protocol, _jp, tp, got = physical_edge_lane
    assert_member_bits(got, tp, protocol, port_sweep=sweep)


def test_levels_are_built_before_the_map(physical_edge_lane, monkeypatch):
    protocol, _jp, tp, got = physical_edge_lane
    assert_levels_built_before_the_map(tp, protocol, got, monkeypatch)


# ----------------------------------------------------------------------
# the rim placement mapped over members, against jax.vmap
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=2)
def physical_edge_items_pair(lane: str):
    """(JAX's arrays, the port's items) of one lane at L0 (float64)."""
    import chip_smoke
    from chip_smoke import physical_edge_inputs, physical_edge_items
    from tools.record_torch_port_fixture import (
        kozlov_sweep_physical_edge_drives_protocol,
        sweep_physical_edge_arrays,
    )

    protocol = kozlov_sweep_physical_edge_drives_protocol()
    want = sweep_physical_edge_arrays(refines=0, lanes=(lane,))
    lane_protocol = protocol["lanes"][lane]
    problems = {lane: make_minimizer(True, gp=lane_protocol["global_parameters"],
                                     edits=lane_protocol, dtype=torch.float64).problem()}
    inputs = physical_edge_inputs(protocol, problems)
    saved, chip_smoke.DEVICE = chip_smoke.DEVICE, "cpu"
    try:
        got = physical_edge_items(torch, problems, protocol, inputs)
    finally:
        chip_smoke.DEVICE = saved
    return want, got, inputs


def assert_lane_items(lane: str, prefix: str) -> None:
    """Every item under ``prefix`` on ``lane``: the port's inputs equal JAX's, its map against
    JAX's (rel ``ITEM_REL`` of the largest entry) and each member against its single call, in
    bits."""
    from chip_smoke import TILT_FIELDS, relative_error

    want, got, inputs = physical_edge_items_pair(lane)
    for f in TILT_FIELDS:
        assert np.array_equal(np.stack([m[f] for m in inputs[lane]]),
                              want["arrays"][f"input/{lane}/{f}"]), f
    items = [k for k in got["vmapped"] if k.startswith(prefix)]
    assert items, prefix
    assert any(np.max(np.abs(np.asarray(want["arrays"][i]))) > 0.0 for i in items), prefix
    for item in items:
        g, w = np.asarray(got["vmapped"][item]), np.asarray(want["arrays"][item])
        assert g.shape == w.shape, item
        assert relative_error(g, w) <= ITEM_REL, f"{item}: {relative_error(g, w):.3e}"
        for m, one in enumerate(got["single"][item]):
            assert np.array_equal(g[m], one), f"{item} member {m}"


@pytest.mark.parametrize("item", ITEMS[:4])
def test_rim_items_match_jax_vmap_and_their_single_calls(item):
    assert_lane_items("physical_edge", f"constraint/rim_slope_match_out/physical_edge/{item}")


def test_the_plain_lane_has_no_shape_enforcement():
    """Without a trace radius the rim placement moves no position (``make_enforce`` is None,
    in both packages)."""
    want, got, _inputs = physical_edge_items_pair("physical_edge")
    assert not [k for k in list(want["arrays"]) + list(got["vmapped"]) if "/enforce/" in k]
