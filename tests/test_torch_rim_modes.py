"""The port's rim-matching modes against the recorded reference and the JAX package.

``ring_average_radial_v1`` and ``shared_rim_staggered_v1`` on meshgen
``kozlov_1disk`` (L0, 177 vertices), each on two variants as
``tests/test_ring_average_rim_mode.py`` and
``tests/test_staggered_rim_mode.py`` build them: ``equal`` (outer ring ==
rim ring, 1:1 pairing) and ``interp`` (every other outer vertex untagged:
arc-length interpolation, sequential staggered enforcement).  The port's
``make_enforce_tilts``, its frozen split, its dense and compact tilt rows
and its dense and compact shape rows are held against

- the reference's recorded results (``tests/fixtures/*_rim_reference.npz``)
  with those tests' tolerances: enforced tilts to atol 1e-12, rows matched
  as sets to 1e-9;
- the JAX package, live, on the same inputs: to 1e-12 of each quantity's
  scale.

More cases against the JAX package alone: the pointwise mode on the
``interp`` variant, a lane without a disk group, theta from the disk ring
(``rim_slope_match_thetaB_param`` unset), and a disk ring of half the rim's
count (the rank-1 mean-field in-rows); on each, the tilt KKT projection of
a seeded gradient and the shape KKT projection (not on ``interp``, whose
shape system is singular in both packages: see the test).  Last, the
ring-average mode through two ``minimize(1)`` with more of the solver's
options (``tests/test_torch_kozlov_reduced.py``'s check).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import ABLATION, assert_close, port_from_jax, to_np
from test_torch_kozlov_reduced import check_minimize

from membrane_solver_tpu.constraints import rim_slope_match_out as jrim
from membrane_solver_tpu.runtime import jit_core as jcore
from membrane_solver_tpu.runtime import tilt_relax as jrelax
from membrane_solver_tpu_torch.constraints import rim_slope_match_out as trim
from membrane_solver_tpu_torch.device.state import MeshState
from membrane_solver_tpu_torch.runtime import jit_core as tcore
from membrane_solver_tpu_torch.runtime import tilt_relax as trelax

FIXTURES = Path(__file__).parent / "fixtures"
NPZ = {"ring_average_radial_v1": FIXTURES / "ring_average_rim_reference.npz",
       "shared_rim_staggered_v1": FIXTURES / "staggered_rim_reference.npz"}
FIXTURE_CASES = [(mode, variant) for mode in NPZ for variant in ("equal", "interp")]
LIVE_CASES = FIXTURE_CASES + [
    ("pointwise_radial_v1", "interp"),
    ("pointwise_radial_v1", "no_disk"),
    ("shared_rim_staggered_v1", "no_disk"),
    ("pointwise_radial_v1", "disk_theta"),
    ("shared_rim_staggered_v1", "disk_theta"),
    ("pointwise_radial_v1", "disk_mean"),
    ("shared_rim_staggered_v1", "disk_mean"),
    ("ring_average_radial_v1", "disk_mean"),
]
REL = 1e-12


def _data(mode: str, variant: str) -> dict:
    from membrane_solver_tpu.meshgen import build

    data = build("kozlov_1disk")
    gp = data["global_parameters"]
    gp["rim_slope_match_mode"] = mode
    if variant == "no_disk":
        gp.pop("rim_slope_match_disk_group")
    if variant == "disk_theta":
        gp.pop("rim_slope_match_thetaB_param")
    seen = {"outer": 0, "disk": 0}
    for v in data["vertices"]:
        opts = v[-1] if isinstance(v[-1], dict) else None
        if not opts:
            continue
        if variant == "interp" and opts.get("preset") == "outer":
            if seen["outer"] % 2 == 1:
                opts.pop("preset")
            seen["outer"] += 1
        if variant == "disk_mean" and opts.get("rim_slope_match_group") == "disk":
            if seen["disk"] % 2 == 1:
                opts.pop("rim_slope_match_group")
            seen["disk"] += 1
    return json.loads(json.dumps(data))


_CACHE: dict = {}


def _case(mode: str, variant: str):
    """(JAX problem, port spec, port (state, topo, params), JAX state) with seeded tilts.

    The fixture's input tilts on its variants, seeded ones elsewhere.
    """
    key = (mode, variant)
    if key in _CACHE:
        return _CACHE[key]
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg

    jp = jpkg.Minimizer(jpkg.parse_geometry(_data(mode, variant)), quiet=True).problem()
    tspec = tpkg.Minimizer(tpkg.parse_geometry(_data(mode, variant)), quiet=True,
                           device="cpu").problem().spec
    assert tspec.static_of(trim._KEY) == jp.spec.static_of(trim._KEY)
    nv = jp.n_vertices
    tin = np.zeros(np.asarray(jp.state.positions).shape)
    tout = np.zeros_like(tin)
    if mode in NPZ and variant in ("equal", "interp"):
        fx = np.load(NPZ[mode])
        ours_row = {int(v): i for i, v in enumerate(jp.vertex_ids)}
        perm = np.array([ours_row[int(v)] for v in fx[f"{variant}/vids"]])
        tin[perm] = fx[f"{variant}/tin0"]
        tout[perm] = fx[f"{variant}/tout0"]
    else:
        rng = np.random.default_rng(7)
        tin[:nv] = 0.1 * rng.standard_normal((nv, 3))
        tout[:nv] = 0.1 * rng.standard_normal((nv, 3))
    js = dataclasses.replace(jp.state, tilts_in=jnp.asarray(tin), tilts_out=jnp.asarray(tout))
    _s, topo, params = port_from_jax(jp)
    ts = MeshState(**{f: torch.as_tensor(np.array(getattr(js, f))[:nv])
                      for f in ("positions", "tilts", "tilts_in", "tilts_out")})
    _CACHE[key] = (jp, tspec, (ts, topo, params), js)
    return _CACHE[key]


def _perm(jp, vids):
    ours_row = {int(v): i for i, v in enumerate(jp.vertex_ids)}
    return np.array([ours_row[int(v)] for v in vids])


def _assert_rows_match(ref_rows, ours_rows):
    """Every live reference row has a counterpart among ours within 1e-9, and the counts agree."""
    ref_live = [r for r in ref_rows if np.abs(r).max() > 0]
    ours_live = [r for r in ours_rows if np.abs(r).max() > 0]
    assert len(ref_live) == len(ours_live)
    for r in ref_live:
        best = min(float(np.abs(o - r).max()) for o in ours_live)
        assert best < 1e-9, f"unmatched reference row (best diff {best})"


@pytest.mark.parametrize("frozen", [False, True], ids=["full", "frozen"])
@pytest.mark.parametrize("mode,variant", LIVE_CASES)
def test_enforce_tilts_matches_jax_and_reference(mode, variant, frozen):
    jp, tspec, (ts, topo, params), js = _case(mode, variant)
    nv = jp.n_vertices
    want = jrim.make_enforce_tilts(jp.spec)(js, jp.topo, jp.params)
    if frozen:
        pre, fn = trim.make_frozen_enforce_tilts(tspec)
        tin, tout = fn(ts.tilts_in, ts.tilts_out, pre(ts, topo, params), topo, params)
    else:
        got = trim.make_enforce_tilts(tspec)(ts, topo, params)
        tin, tout = got.tilts_in, got.tilts_out
    assert_close(tin, np.asarray(want.tilts_in)[:nv], REL, "tilts_in vs JAX", atol_scale=1.0)
    assert_close(tout, np.asarray(want.tilts_out)[:nv], REL, "tilts_out vs JAX", atol_scale=1.0)
    if (mode, variant) in FIXTURE_CASES:
        fx = np.load(NPZ[mode])
        perm = _perm(jp, fx[f"{variant}/vids"])
        np.testing.assert_allclose(to_np(tin)[perm], fx[f"{variant}/tin1"], atol=1e-12, rtol=0)
        np.testing.assert_allclose(to_np(tout)[perm], fx[f"{variant}/tout1"], atol=1e-12, rtol=0)


@pytest.mark.parametrize("mode,variant", LIVE_CASES)
def test_tilt_rows_match_jax_and_reference(mode, variant):
    jp, tspec, (ts, topo, params), js = _case(mode, variant)
    nv = jp.n_vertices
    want = np.asarray(jrim.make_tilt_constraint_rows(jp.spec)(js, jp.topo, jp.params))[:, :, :nv]
    got = to_np(trim.make_tilt_constraint_rows(tspec)(ts, topo, params))
    live = np.abs(want).reshape(want.shape[0], -1).max(axis=1) > 0
    # the port's rings have no capacity padding: its rows are the JAX live rows
    assert got.shape[0] <= want.shape[0]
    assert_close(got[np.abs(got).reshape(got.shape[0], -1).max(axis=1) > 0], want[live], REL,
                 "dense tilt rows vs JAX", atol_scale=1.0)
    if (mode, variant) in FIXTURE_CASES:
        fx = np.load(NPZ[mode])
        perm = _perm(jp, fx[f"{variant}/rows_vids"])
        k_ref = int(fx[f"{variant}/rows_k"])
        ref_gin, ref_gout = fx[f"{variant}/rows_gin"][:k_ref], fx[f"{variant}/rows_gout"][:k_ref]
        if mode == "ring_average_radial_v1":
            _assert_rows_match(list(ref_gin) + list(ref_gout),
                               list(got[:, 0][:, perm]) + list(got[:, 1][:, perm]))
            assert got.shape[0] <= 2
        else:
            _assert_rows_match(ref_gout, got[:, 1][:, perm])
            _assert_rows_match(ref_gin, got[:, 0][:, perm])


def _dense_from_compact(compact, n_rows):
    """(k, 2, Nv, 3) rows from compact (values, rows, leaflet[, bg_coeff, bg_field]) slots."""
    vals, rows, leaf = (to_np(x) for x in compact[:3])
    k = vals.shape[0]
    out = np.zeros((k, 2, n_rows, 3))
    for i in range(k):
        for a in range(vals.shape[1]):
            out[i, int(leaf[i, a]), int(rows[i, a])] += vals[i, a]
    if len(compact) == 5:
        out += to_np(compact[3])[:, None, None, None] * to_np(compact[4])[None]
    return out


@pytest.mark.parametrize("mode,variant", LIVE_CASES)
def test_compact_tilt_rows_match_jax(mode, variant):
    jp, tspec, (ts, topo, params), js = _case(mode, variant)
    nv = jp.n_vertices
    jmaker, tmaker = jrim.make_compact_tilt_rows(jp.spec), trim.make_compact_tilt_rows(tspec)
    assert (jmaker is None) == (tmaker is None)
    if tmaker is None:  # ring average: the dense rows carry the mode
        assert mode == "ring_average_radial_v1"
        return
    jc, tc = jmaker(js, jp.topo, jp.params), tmaker(ts, topo, params)
    assert len(jc) == len(tc)
    want = _dense_from_compact(jc, jp.spec.nv_cap)[:, :, :nv]
    got = _dense_from_compact(tc, nv)
    live = np.abs(want).reshape(want.shape[0], -1).max(axis=1) > 0
    got_live = np.abs(got).reshape(got.shape[0], -1).max(axis=1) > 0
    assert_close(got[got_live], want[live], REL, "compact tilt rows vs JAX", atol_scale=1.0)
    # the compact rows span the dense rows' space
    dense = to_np(trim.make_tilt_constraint_rows(tspec)(ts, topo, params))
    assert_close(got, dense, REL, "compact vs dense tilt rows", atol_scale=1.0)


@pytest.mark.parametrize("mode,variant", LIVE_CASES)
def test_shape_rows_match_jax_and_reference(mode, variant):
    jp, tspec, (ts, topo, params), js = _case(mode, variant)
    nv = jp.n_vertices
    want = np.asarray(jrim.make_constraint_gradient_rows(jp.spec)(js, jp.topo, jp.params))
    want = want[:, :nv]
    got = to_np(trim.make_constraint_gradient_rows(tspec)(ts, topo, params))
    live = np.abs(want).reshape(want.shape[0], -1).max(axis=1) > 0
    got_live = np.abs(got).reshape(got.shape[0], -1).max(axis=1) > 0
    assert_close(got[got_live], want[live], REL, "dense shape rows vs JAX", atol_scale=1.0)
    jmaker, tmaker = jrim.make_compact_constraint_rows(jp.spec), trim.make_compact_constraint_rows(tspec)
    assert (jmaker is None) == (tmaker is None)
    if tmaker is not None:
        vals, rows = (to_np(x) for x in tmaker(ts, topo, params))
        compact = np.zeros((vals.shape[0], nv, 3))
        for i in range(vals.shape[0]):
            for a in range(vals.shape[1]):
                compact[i, int(rows[i, a])] += vals[i, a]
        assert_close(compact, got, REL, "compact vs dense shape rows", atol_scale=1.0)
    if mode == "ring_average_radial_v1" and variant in ("equal", "interp"):
        fx = np.load(NPZ[mode])
        perm = _perm(jp, fx[f"{variant}/rows_vids"])
        assert got.shape[0] == 1, "ring average aggregates the shape family"
        k_ref = int(fx[f"{variant}/shape_k"])
        for r in [r for r in fx[f"{variant}/shape_rows"][:k_ref] if np.abs(r).max() > 0]:
            best = min(min(float(np.abs(o - r).max()), float(np.abs(o + r).max()))
                       for o in got[:, perm])
            assert best < 1e-9, f"unmatched reference shape aggregate (diff {best})"


@pytest.mark.parametrize("mode,variant", LIVE_CASES)
def test_kkt_projections_match_jax(mode, variant):
    """The tilt KKT projection (compact or dense, as the relax picks) and the shape one."""
    jp, tspec, (ts, topo, params), js = _case(mode, variant)
    nv = jp.n_vertices
    rng = np.random.default_rng(11)
    g = np.zeros((3,) + np.asarray(jp.state.positions).shape)
    g[:, :nv] = rng.standard_normal((3, nv, 3))
    jcollect, tcollect = jrelax.make_compact_tilt_collector(jp.spec), trelax.make_compact_tilt_collector(tspec)
    assert (jcollect is None) == (tcollect is None)
    if tcollect is None:
        jproj = jrelax.make_tilt_projector(
            jrelax.make_tilt_constraint_rows(jp.spec)(js, jp.topo, jp.params))
        tproj = trelax.make_tilt_projector(trelax.make_tilt_constraint_rows(tspec)(ts, topo, params))
    else:
        jproj = jrelax.make_compact_tilt_projector(jcollect(js, jp.topo, jp.params))
        tproj = trelax.make_compact_tilt_projector(tcollect(ts, topo, params), nv)
    want = jproj(jnp.asarray(g[0]), jnp.asarray(g[1]))
    got = tproj(torch.as_tensor(g[0, :nv]), torch.as_tensor(g[1, :nv]))
    for w, t, what in zip(want, got, ("in", "out")):
        assert_close(t, np.asarray(w)[:nv], 1e-10, f"tilt projection {what}", atol_scale=1.0)
    if variant == "interp":
        # the rim rows' pinned rim slots project out, which leaves k rows on
        # the k/2 outer vertices: the shape system is singular to round-off
        # in both packages (its multipliers are round-off), so only the
        # tilt projection compares there
        return
    want_g = jcore.make_gradient_projector(jp.spec)(jnp.asarray(g[2]), js, jp.topo, jp.params)
    got_g = tcore.make_gradient_projector(tspec)(torch.as_tensor(g[2, :nv]), ts, topo, params)
    assert_close(got_g, np.asarray(want_g)[:nv], 1e-10, "shape projection", atol_scale=1.0)


# the ring-average mode through minimize, with the curved-theta ablation,
# the per-step refresh every second accepted step and the unpreconditioned
# CG, which amplifies round-off about 20x per iteration (in the JAX package
# alone 1e-15 of tilt noise grows to 1e-6 in 6 iterations), so it relaxes 3
RING_AVERAGE_GROUP = {
    "rim_slope_match_mode": "ring_average_radial_v1",
    "tilt_projection_interval": 2,
    "tilt_cg_preconditioner": "none",
    "tilt_inner_steps": 3,
    **ABLATION,
}


def test_ring_average_minimize_matches_jax():
    check_minimize(RING_AVERAGE_GROUP)
