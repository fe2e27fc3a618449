"""The port's coupled leaflet-tilt relax against the JAX package's.

float64: the per-module frozen path on both sides; same accepted steps,
final energy to rel 1e-10, tilts to 1e-9 of the tilt scale, over 20 CG
iterations.  Past about 30 iterations the relax works at the float64
resolution of its energy: the accept-if-not-worse test compares energies
equal to ~1e-16, so a summation-order difference can flip a late accept
decision; over the lane's full 40 iterations only the final energy is held
(rel 1e-12).  float32: the fused frozen-tilt path on both sides (the JAX
Pallas kernel in interpret mode, the port's kernel wrapper on its CPU
twins) over 6 iterations: same accepted steps, energy to rel 5e-5, tilts to
5e-4 of the tilt scale (the JAX package's own fused-vs-stock protocol and
bounds, test_pallas_frozen_tilt.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import SMALL, make_minimizer, perturbed_pair, port_from_jax, to_np

from membrane_solver_tpu.runtime import tilt_relax as jrelax
from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
from membrane_solver_tpu_torch.runtime import tilt_relax as trelax

ITERS_F64 = 20
ITERS_LANE = 40
ITERS_F32 = 6
STEP = 0.15
TOL = 1e-10


@pytest.fixture(scope="module", params=[0, 1], ids=["L0", "L1"])
def lane(request):
    jm = make_minimizer(False, kw=SMALL, refines=request.param)
    tm = make_minimizer(True, kw=SMALL, refines=request.param)
    return jm.problem(), tm.problem().spec


def _jax_relax(spec):
    # a fresh trace: the package memoizes its relax per spec, and the fused
    # kernel gate is read while tracing
    return jax.jit(jrelax.make_relax_leaflet_tilts.__wrapped__(spec))


def _cast_jax(jp, js, dtype):
    state = dataclasses.replace(
        js, **{f: getattr(js, f).astype(dtype)
               for f in ("positions", "tilts", "tilts_in", "tilts_out")}
    )
    params = {k: jnp.asarray(v, dtype) for k, v in jp.params.items()}
    return state, params


def _run_both(jp, tspec, perturbed, dtype, iters):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    if perturbed:
        js, _ts = perturbed_pair(jp, seed=31)
    else:
        js = jp.state
    js, jparams = _cast_jax(jp, js, jdtype)
    nv = jp.n_vertices
    from membrane_solver_tpu_torch.device.state import MeshState

    ts = MeshState(**{f: torch.as_tensor(np.array(getattr(js, f))[:nv], dtype=dtype)
                      for f in ("positions", "tilts", "tilts_in", "tilts_out")})
    _s, topo, tparams = port_from_jax(jp, dtype=dtype)
    jout, jstats = _jax_relax(jp.spec)(
        js, jp.topo, jparams, jnp.asarray(iters, jnp.int32), jnp.asarray(STEP, jdtype),
        jnp.asarray(TOL, jdtype),
    )
    tout, tstats = trelax.make_relax_leaflet_tilts(tspec)(ts, topo, tparams, iters, STEP, TOL)
    return jout, jstats, tout, tstats, nv


def _assert_relax_match(jout, jstats, tout, tstats, nv, e_rtol, t_rtol):
    assert tstats.accepted_steps == int(jstats.accepted_steps)
    assert tstats.rejected == bool(jstats.rejected)
    assert tstats.accepted_steps > 0
    assert tstats.final_energy == pytest.approx(float(jstats.final_energy), rel=e_rtol)
    assert tstats.initial_energy == pytest.approx(float(jstats.initial_energy), rel=e_rtol)
    wants = [np.asarray(getattr(jout, n), np.float64)[:nv] for n in ("tilts_in", "tilts_out")]
    scale = max(float(np.max(np.abs(w))) for w in wants) or 1.0
    for name, want in zip(("tilts_in", "tilts_out"), wants):
        got = to_np(getattr(tout, name))
        assert float(np.max(np.abs(got - want))) <= t_rtol * scale, name


@pytest.mark.parametrize("perturbed", [False, True], ids=["flat", "perturbed"])
def test_relax_f64_matches_jax(lane, perturbed):
    jp, tspec = lane
    jout, jstats, tout, tstats, nv = _run_both(jp, tspec, perturbed, torch.float64, ITERS_F64)
    _assert_relax_match(jout, jstats, tout, tstats, nv, 1e-10, 1e-9)


def test_relax_f64_lane_iterations_final_energy(lane):
    jp, tspec = lane
    _jout, jstats, _tout, tstats, _nv = _run_both(jp, tspec, True, torch.float64, ITERS_LANE)
    assert tstats.accepted_steps > ITERS_F64
    assert tstats.final_energy == pytest.approx(float(jstats.final_energy), rel=1e-12)


@pytest.mark.parametrize("perturbed", [False, True], ids=["flat", "perturbed"])
def test_relax_f32_fused_path_matches_jax_fused_path(lane, perturbed, monkeypatch):
    monkeypatch.setenv("MEMBRANE_SOLVER_PALLAS", "1")
    jp, tspec = lane
    engaged = []
    build = trelax.build_fused_tilt_energy

    def spy(*args, **kw):
        out = build(*args, **kw)
        engaged.append(out is not None)
        return out

    monkeypatch.setattr(trelax, "build_fused_tilt_energy", spy)
    launches = dict(ft.LAUNCHES)
    jout, jstats, tout, tstats, nv = _run_both(jp, tspec, perturbed, torch.float32, ITERS_F32)
    assert engaged == [True]
    assert ft.LAUNCHES == launches  # the CPU runs the twins
    assert tout.tilts_in.dtype == torch.float32
    _assert_relax_match(jout, jstats, tout, tstats, nv, 5e-5, 5e-4)


def test_fused_path_matches_per_module_path_f32(lane, monkeypatch):
    """The fused energy and the per-module frozen energies give the same relax."""
    jp, tspec = lane
    from membrane_solver_tpu_torch.device.state import MeshState

    _s, topo, params = port_from_jax(jp, dtype=torch.float32)
    js, _ts = perturbed_pair(jp, seed=41)
    ts = MeshState(**{f: torch.as_tensor(np.array(getattr(js, f))[: jp.n_vertices],
                                         dtype=torch.float32)
                      for f in ("positions", "tilts", "tilts_in", "tilts_out")})
    relax = trelax.make_relax_leaflet_tilts(tspec)
    fused_out, fused_stats = relax(ts, topo, params, ITERS_F32, STEP, TOL)
    monkeypatch.setattr(trelax, "build_fused_tilt_energy", lambda *a, **k: None)
    plain_out, plain_stats = relax(ts, topo, params, ITERS_F32, STEP, TOL)
    assert fused_stats.accepted_steps == plain_stats.accepted_steps
    assert fused_stats.final_energy == pytest.approx(plain_stats.final_energy, rel=5e-5)
    scale = float(torch.max(torch.abs(plain_out.tilts_in)))
    assert float(torch.max(torch.abs(fused_out.tilts_in - plain_out.tilts_in))) <= 5e-4 * scale


def test_tilt_energy_matches_frozen_program(lane):
    """make_tilt_energy (in-loop objectives) equals the frozen program's energy."""
    jp, tspec = lane
    js, ts = perturbed_pair(jp, seed=51)
    _s, topo, params = port_from_jax(jp)
    full = float(trelax.make_tilt_energy(tspec)(ts, topo, params))
    e_pre, e_fns, _c_pre, _c_fns, _names = trelax.collect_frozen_tilt_program(tspec)
    frozen = sum(
        float(fn(ts.tilts_in, ts.tilts_out, pre(ts, topo, params), topo, params))
        for pre, fn in zip(e_pre, e_fns)
    )
    assert frozen == pytest.approx(full, rel=1e-13)
    want = float(jrelax.make_tilt_energy(jp.spec)(js, jp.topo, jp.params))
    assert full == pytest.approx(want, rel=1e-10)
