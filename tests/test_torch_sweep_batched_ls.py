"""The sweep's member line search in its batched form against its sequential form and JAX.

The member block scores its Armijo candidates in one of two forms
(``utils/tuning.batched_line_search``: sequential on the CPU, batched on
the card, ``MEMBRANE_SOLVER_BATCHED_LS`` overriding either).  Batched:
candidate 0 of all members in one map, then candidates 1-9 of the members
that rejected it as one (members x candidates) axis, three host reads a
search.  Held here on the CPU, each form forced through the variable:

- (a) both forms give every member the same flags, the same stats
  (``trials`` aside: it counts as each single-problem form counts) and one
  sha256 of every state field, at float64 and float32, on kozlov L0 with
  seeded heights at a step that rejects candidate 0 (the tail), the
  vesicle at L1 at a step where some members accept candidate 0 and some
  a tail candidate, the scaffold lane's ``trace_z`` fallback at L0 (from
  its own first lane step), and a mixed block whose members accept at
  candidate 0, in the tail, fail, and converge at the first gradient;
- (b) each member of a batched block is its one-member batched block's
  bits, and the tail scored in chunks of a few rows gives the unchunked
  bits;
- (c) the port's batched sweep against JAX's ``run_sweep`` with
  ``MEMBRANE_SOLVER_BATCHED_LS=1`` set before it traces (JAX's batched
  search under its sweep's ``vmap``) on kozlov L0, three members, two steps
  through the tail, at rel 1e-10 with equal flags and iterations;
- (d) a batched search makes three host reads (``member_block._host``), and
  its tail's rows are nine per member that rejected candidate 0, no other;
- (e) placed on ``[cpu, cpu]`` the mixed block gives the unplaced bits
  under both forms, each group asking for the form of its own device.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import pytest
import torch

from membrane_solver_tpu_torch.parallel import member_block
from membrane_solver_tpu_torch.runtime.jit_core import LS_MAX_ITER
from tests._torch_port_harness import make_minimizer, make_vesicle_minimizer, seed_host

ENV = "MEMBRANE_SOLVER_BATCHED_LS"
REL = 1e-10
SEED = 5
STEPS = 2
TAIL_STEP = 1e-2  # kozlov L0: candidate 0 and more rotate a normal past the limit
# the mixed block's members: accept at candidate 0, in the tail, fail, converge at once
MIXED_STEPS = (1e-3, 1e-2, 0.1, 1e-3)
MIXED_TOL = 60.0  # between the flat member's gradient norm (~55) and the others' (~67-93)
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def digest(out) -> str:
    """sha256 of every state field and every stat but ``trials``."""
    states, _ss, stats = out
    h = hashlib.sha256()
    for f in dataclasses.fields(states):
        h.update(getattr(states, f.name).detach().cpu().numpy().tobytes())
    for f in dataclasses.fields(stats):
        if f.name != "trials":
            h.update(np.asarray(getattr(stats, f.name)).tobytes())
    return h.hexdigest()


def both_forms(run, monkeypatch) -> dict:
    """``run()`` under the sequential and the batched form: {form: (result, search records)}."""
    out = {}
    for form, value in (("sequential", "0"), ("batched", "1")):
        monkeypatch.setenv(ENV, value)
        monkeypatch.setattr(member_block, "SEARCH_RECORD", [])
        out[form] = (run(), member_block.SEARCH_RECORD)
    monkeypatch.setattr(member_block, "SEARCH_RECORD", None)
    return out


def assert_same_bits(a, b) -> None:
    for f in dataclasses.fields(a[0]):
        assert torch.equal(getattr(a[0], f.name), getattr(b[0], f.name)), f.name
    for f in dataclasses.fields(a[2]):
        if f.name != "trials":
            assert np.asarray(getattr(a[2], f.name)).tobytes() == \
                np.asarray(getattr(b[2], f.name)).tobytes(), f.name
    assert digest(a) == digest(b)


# ----------------------------------------------------------------- the lanes
@pytest.fixture(scope="module")
def kozlov():
    """dtype name -> kozlov L0 with seeded heights and tilts."""
    cache = {}

    def get(name):
        if name not in cache:
            mn = make_minimizer(True, device="cpu", dtype=DTYPES[name])
            seed_host(mn, SEED)
            cache[name] = mn.problem()
        return cache[name]

    return get


def kozlov_members(problem):
    from tests.test_torch_sweep import members

    return members(problem.params, problem.state.positions.numpy(), missing=False)


def kozlov_sweep(problem, step=TAIL_STEP, pick=None, mesh=None):
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep

    params, positions = kozlov_members(problem)
    if pick is not None:
        params, positions = params[pick:pick + 1], positions[pick:pick + 1]
    return run_sweep(problem, params, STEPS, step_size=step, member_positions=positions,
                     device_mesh=mesh)


@functools.lru_cache(maxsize=2)
def _flat_start(dtype) -> np.ndarray:
    return make_minimizer(True, device="cpu", dtype=dtype).problem().state.positions.numpy()


def flat_start(problem) -> np.ndarray:
    """Kozlov L0's unseeded positions: flat, a gradient norm of ~55 under the seeded tilts."""
    return _flat_start(problem.state.positions.dtype)


def mixed_block(problem, members=range(4), mesh=None):
    """The kozlov L0 block of four members at their own step sizes (``MIXED_STEPS``): member 3
    starts flat and converges at the first gradient (``MIXED_TOL``)."""
    from membrane_solver_tpu_torch.parallel.sweep import batch_problem, make_sweep_minimize
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    params, positions = kozlov_members(problem)
    params, positions = params + [dict(params[0])], positions + [flat_start(problem)]
    sel = list(members)
    batch = batch_problem(problem, [params[m] for m in sel],
                          member_positions=[positions[m] for m in sel])
    like = problem.state.positions
    ss = member_block.fresh_member_stepper(len(sel), problem.n_vertices, "gradient_descent",
                                           dtype=like.dtype, device=like.device)
    run = make_sweep_minimize(problem.spec, MinimizeOptions(), device_mesh=mesh)
    return run(batch.states, problem.topo, batch.params, ss, STEPS,
               np.asarray([MIXED_STEPS[m] for m in sel]), 1e-3, MIXED_TOL, 1e-8, 10,
               np.zeros(len(sel), dtype=np.int64))


def vesicle_sweep(name: str):
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions
    from tests.test_torch_sweep_shape import members

    mn = make_vesicle_minimizer(True, 1, dtype=DTYPES[name])
    seed_host(mn, SEED)
    p = mn.problem()
    params, positions = members("vesicle", p.params, p.state.positions.numpy())
    return lambda: run_sweep(p, params, STEPS, step_size=TAIL_STEP,
                             options=MinimizeOptions(enforce_in_line_search=True),
                             member_positions=positions)


def scaffold_sweep(name: str):
    """The scaffold lane at L0 after its first lane step (its fallback is viable there), one
    sweep step of the fixture's protocol (``chip_smoke.sweep_members``)."""
    from tests.test_torch_sweep_physical_edge import fixture, sweep

    protocol = fixture("kozlov_L3_scaffold_sweep_f64_jax.json")["protocol"]
    lane = protocol["kozlov"]
    mn = make_minimizer(True, gp=lane["global_parameters"], edits=lane, dtype=DTYPES[name])
    mn.minimize(1)
    p = mn.problem()
    return lambda: sweep(p, dict(protocol, steps=1), True)


# ------------------------------------------------------ (a) the forms agree
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("lane", ["kozlov_tail", "vesicle", "scaffold", "mixed"])
def test_forms_give_the_same_bits(kozlov, lane, name, monkeypatch):
    if lane == "kozlov_tail":
        run = lambda: kozlov_sweep(kozlov(name))  # noqa: E731
    elif lane == "mixed":
        run = lambda: mixed_block(kozlov(name))  # noqa: E731
    else:
        run = (vesicle_sweep if lane == "vesicle" else scaffold_sweep)(name)
    forms = both_forms(run, monkeypatch)
    (seq, seq_rec), (bat, bat_rec) = forms["sequential"], forms["batched"]
    assert_same_bits(seq, bat)
    assert {r["form"] for r in seq_rec} == {"sequential"}
    assert {r["form"] for r in bat_rec} == {"batched"}
    assert any(r["rows"] for r in bat_rec), "no search reached the tail"
    stats = bat[2]
    if lane == "vesicle":
        # some members accept candidate 0, some a tail candidate
        assert np.all(np.asarray(stats.accepted_steps) == STEPS)
        assert any(r["rows"] < 9 * 3 for r in bat_rec)
    if lane == "scaffold":
        assert np.asarray(stats.trace_z_fallbacks).sum() > 0
    if lane == "mixed":
        assert np.asarray(stats.converged).tolist() == [False, False, False, True]
        assert np.asarray(stats.accepted_steps).tolist() == [STEPS, STEPS, STEPS - 1, 0]
        assert np.asarray(stats.iterations).tolist() == [STEPS, STEPS, STEPS, 1]


# ------------------------------------------- (b) members and chunks, in bits
def test_member_is_its_one_member_batched_block(kozlov, monkeypatch):
    monkeypatch.setenv(ENV, "1")
    p = kozlov("f64")
    got = mixed_block(p)
    for m in range(4):
        one = mixed_block(p, members=[m])
        for f in dataclasses.fields(got[0]):
            assert torch.equal(getattr(got[0], f.name)[m], getattr(one[0], f.name)[0]), \
                f"member {m}: {f.name}"
        for f in dataclasses.fields(got[2]):
            assert np.asarray(getattr(got[2], f.name))[m].tobytes() == \
                np.asarray(getattr(one[2], f.name))[0].tobytes(), f"member {m}: {f.name}"


@pytest.mark.parametrize("name", list(DTYPES))
def test_chunked_tail_gives_the_unchunked_bits(kozlov, name, monkeypatch):
    monkeypatch.setenv(ENV, "1")
    p = kozlov(name)
    monkeypatch.setattr(member_block, "SEARCH_RECORD", [])
    whole = kozlov_sweep(p)
    assert {r["chunks"] for r in member_block.SEARCH_RECORD if r["rows"]} == {1}
    # four rows a chunk: the 27 rows of three rejecting members in seven maps
    rows = member_block.tail_chunk_rows(p.topo, p.state.positions.dtype)
    monkeypatch.setattr(member_block, "TAIL_CHUNK_BYTES", member_block.TAIL_CHUNK_BYTES // rows * 4)
    assert member_block.tail_chunk_rows(p.topo, p.state.positions.dtype) == 4
    monkeypatch.setattr(member_block, "SEARCH_RECORD", [])
    chunked = kozlov_sweep(p)
    rec = [r for r in member_block.SEARCH_RECORD if r["rows"]]
    assert rec and all(r["chunks"] == -(-r["rows"] // 4) > 1 for r in rec)
    assert all(r["reads"] == 3 for r in rec)
    assert_same_bits(whole, chunked)


# --------------------------------------------------------------- (c) JAX
def test_batched_sweep_matches_jax_batched_sweep(kozlov, monkeypatch):
    """JAX traces its sweep with the batched search (candidates inside members) on the CPU."""
    import jax

    from membrane_solver_tpu.parallel.sweep import run_sweep
    from membrane_solver_tpu.runtime.jit_core import MinimizeOptions
    from tests.test_torch_sweep import assert_members_close, members

    monkeypatch.setenv(ENV, "1")
    jm = make_minimizer(False)
    seed_host(jm, SEED)
    jp = jm.problem()
    params, positions = members(jp.params, np.asarray(jp.state.positions), missing=False)
    jax.clear_caches()
    try:
        want = run_sweep(jp, params, STEPS, step_size=TAIL_STEP, options=MinimizeOptions(),
                         member_positions=positions)
        jax.block_until_ready(want[0].positions)
    finally:
        jax.clear_caches()
    p = kozlov("f64")
    monkeypatch.setattr(member_block, "SEARCH_RECORD", [])
    got = kozlov_sweep(p)
    assert any(r["rows"] for r in member_block.SEARCH_RECORD)
    assert_members_close(got, want, p.n_vertices, REL)
    assert np.asarray(got[2].iterations).tolist() == [STEPS] * 3


# ---------------------------------------------------- (d) reads and rows
def test_batched_search_reads_and_tail_rows(kozlov, monkeypatch):
    """Three host reads a batched search (the sequential form reads once per round), and the
    tail's rows are nine per member whose candidate 0 was rejected, in member order."""
    p = kozlov("f64")
    reads, gathered, searches = [0], [], []
    host, gather, search = member_block._host, member_block._members, \
        member_block.member_line_search

    def counted_host(*tensors):
        reads[0] += 1
        return host(*tensors)

    def recorded_members(states, params, rows):
        gathered[-1].append(rows.cpu().numpy())
        return gather(states, params, rows)

    def recorded_search(*args, **kw):
        before = reads[0]
        gathered.append([])
        res = search(*args, **kw)
        searches.append((reads[0] - before, np.concatenate(gathered[-1]) if gathered[-1]
                         else np.zeros(0, dtype=np.int64), res))
        return res

    monkeypatch.setattr(member_block, "_host", counted_host)
    monkeypatch.setattr(member_block, "_members", recorded_members)
    monkeypatch.setattr(member_block, "member_line_search", recorded_search)
    forms = both_forms(lambda: mixed_block(p), monkeypatch)
    n_seq = len(forms["sequential"][1])
    seq, bat = searches[:n_seq], searches[n_seq:]
    assert len(bat) == len(forms["batched"][1]) == STEPS
    for (n_reads, rows, res), rec in zip(bat, forms["batched"][1]):
        tail = np.flatnonzero(res.trials == LS_MAX_ITER)
        assert n_reads == rec["reads"] == 3
        assert rows.tolist() == np.repeat(tail, LS_MAX_ITER - 1).tolist()
        assert rec["rows"] == 9 * tail.size
    # the first search: member 0 accepts candidate 0, members 1-2 reach the tail, member 3
    # has converged
    first = bat[0][2]
    assert first.trials.tolist() == [1, LS_MAX_ITER, LS_MAX_ITER, 0]
    assert first.success.tolist() == [True, True, False, False]
    assert all(n == rec["reads"] for (n, _r, _s), rec in zip(seq, forms["sequential"][1]))
    assert min(n for n, _r, _s in seq) > 3


# ------------------------------------------------------- (e) placement
def test_placed_groups_give_the_unplaced_bits_under_both_forms(kozlov, monkeypatch):
    p = kozlov("f64")
    asked = []
    form_of = member_block.batched_line_search

    def recorded(device):
        asked.append(torch.device(device).type)
        return form_of(device)

    monkeypatch.setattr(member_block, "batched_line_search", recorded)
    for value in ("0", "1"):
        monkeypatch.setenv(ENV, value)
        asked.clear()
        assert_same_bits(mixed_block(p, mesh=["cpu", "cpu"]), mixed_block(p))
        assert asked == ["cpu"] * 3  # once per block call: two groups, then the unplaced block


def test_the_form_follows_the_device(kozlov, monkeypatch):
    """With the variable unset the CPU takes the sequential form; the block asks once per call,
    for its states' device."""
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setattr(member_block, "SEARCH_RECORD", [])
    kozlov_sweep(kozlov("f64"))
    assert {r["form"] for r in member_block.SEARCH_RECORD} == {"sequential"}
    from membrane_solver_tpu_torch.utils import tuning

    assert tuning.batched_line_search("cuda") and not tuning.batched_line_search("cpu")
