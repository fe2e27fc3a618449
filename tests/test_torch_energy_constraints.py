"""The port's energies and constraints against the JAX package at float64.

The six energies of the kozlov lane (values, shape gradients and leaflet
tilt gradients), the geometric and tilt constraint enforcement (full and
frozen), the compact tilt KKT projector and the projected shape gradient
must agree to rel 1e-10 on the flat start and on a seeded perturbed state,
on the small lane at L0 (disk and rim rings pair 1:1) and L1 (they do not:
the mean-field disk coupling).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import SMALL, assert_close, make_minimizer, perturbed_pair, port_from_jax

from membrane_solver_tpu.device import geo as jgeo
from membrane_solver_tpu.energy import get_module as jget_module
from membrane_solver_tpu.runtime import jit_core as jcore
from membrane_solver_tpu.runtime import tilt_relax as jrelax
from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.energy import get_module as tget_module
from membrane_solver_tpu_torch.runtime import jit_core as tcore
from membrane_solver_tpu_torch.runtime import tilt_relax as trelax

RTOL = 1e-10
ENERGIES = ("surface", "tilt_in", "tilt_out", "bending_tilt_in", "bending_tilt_out",
            "tilt_thetaB_contact_in")


@pytest.fixture(scope="module", params=[0, 1], ids=["L0", "L1"])
def lane(request):
    """JAX problem and the port's spec, topology and params on identical inputs."""
    jm = make_minimizer(False, kw=SMALL, refines=request.param)
    tm = make_minimizer(True, kw=SMALL, refines=request.param)
    jp = jm.problem()
    _state, topo, params = port_from_jax(jp)
    return jp, tm.problem().spec, topo, params


def _states(jp, perturbed):
    if perturbed:
        return perturbed_pair(jp, seed=21)
    return jp.state, port_from_jax(jp)[0]


def _energy_fn(get_module, name, spec):
    mod = get_module(name)
    maker = getattr(mod, "make_energy", None)
    return maker(spec) if maker is not None else mod.energy


def _jax_value_and_grads(fn, jp, js):
    topo, params = jp.topo, jp.params

    def f(pos, tin, tout):
        st = dataclasses.replace(js, positions=pos, tilts_in=tin, tilts_out=tout)
        geo = jgeo.triangle_geometry(pos, topo.tri_rows, topo.tri_valid)
        return fn(geo, st, topo, params)

    E, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(js.positions, js.tilts_in, js.tilts_out)
    nv = jp.n_vertices
    return float(E), [np.asarray(g)[:nv] for g in grads]


def _port_value_and_grads(fn, ts, topo, params):
    x, a, b = (t.clone().requires_grad_(True) for t in (ts.positions, ts.tilts_in, ts.tilts_out))
    st = dataclasses.replace(ts, positions=x, tilts_in=a, tilts_out=b)
    geo = tgeo.triangle_geometry(x, topo.tri_rows, topo.tri_valid)
    E = fn(geo, st, topo, params)
    if not E.requires_grad:
        return float(E), [torch.zeros_like(t) for t in (x, a, b)]
    grads = torch.autograd.grad(E, (x, a, b), allow_unused=True)
    return float(E.detach()), [
        torch.zeros_like(t) if g is None else g for g, t in zip(grads, (x, a, b))
    ]


@pytest.mark.parametrize("perturbed", [False, True], ids=["flat", "perturbed"])
@pytest.mark.parametrize("name", ENERGIES)
def test_energy_value_and_gradients_match_jax(lane, name, perturbed):
    jp, tspec, topo, params = lane
    js, ts = _states(jp, perturbed)
    Ej, gj = _jax_value_and_grads(_energy_fn(jget_module, name, jp.spec), jp, js)
    Et, gt = _port_value_and_grads(_energy_fn(tget_module, name, tspec), ts, topo, params)
    assert Et == pytest.approx(Ej, rel=RTOL, abs=1e-13), name
    for got, want, what in zip(gt, gj, ("positions", "tilts_in", "tilts_out")):
        assert_close(got, want, RTOL, f"{name} d/d{what}", atol_scale=1.0)


@pytest.mark.parametrize("perturbed", [False, True], ids=["flat", "perturbed"])
def test_total_energy_and_projected_gradient_match_jax(lane, perturbed):
    jp, tspec, topo, params = lane
    js, ts = _states(jp, perturbed)
    Ej, gj = jcore.make_energy_and_grad(jp.spec)(js, jp.topo, jp.params)
    vg = tcore.make_energy_vg(tspec)
    Et, gt = vg(ts.positions, ts, topo, params)
    gt = tcore.make_gradient_projector(tspec)(gt, ts, topo, params)
    gt = torch.where(topo.fixed_mask[:, None], 0.0, gt)
    assert float(Et) == pytest.approx(float(Ej), rel=RTOL)
    assert_close(gt, np.asarray(gj)[: jp.n_vertices], RTOL, "projected shape gradient",
                 atol_scale=1.0)
    breakdown = tcore.make_energy_breakdown(tspec)(ts, topo, params)
    assert sum(float(v) for v in breakdown.values()) == pytest.approx(float(Et), rel=1e-12)


def test_projector_on_seeded_gradient_matches_jax(lane):
    """All three projector channels on a dense random gradient."""
    jp, tspec, topo, params = lane
    js, ts = _states(jp, True)
    rng = np.random.default_rng(4)
    g = np.zeros((jp.spec.nv_cap, 3))
    g[: jp.n_vertices] = rng.standard_normal((jp.n_vertices, 3))
    want = jcore.make_gradient_projector(jp.spec)(jnp.asarray(g), js, jp.topo, jp.params)
    got = tcore.make_gradient_projector(tspec)(
        torch.as_tensor(g[: jp.n_vertices]), ts, topo, params
    )
    assert_close(got, np.asarray(want)[: jp.n_vertices], RTOL, "projected gradient")


def test_dense_constraint_rows_match_jax(lane):
    """Every module's dense KKT rows, in order (the JAX tables' padding rows are zero)."""
    jp, tspec, topo, params = lane
    js, ts = _states(jp, True)
    nv = jp.n_vertices
    want = np.asarray(jcore.make_constraint_gradients(jp.spec)(js, jp.topo, jp.params))
    got = tcore.make_constraint_gradients(tspec)(ts, topo, params).numpy()
    assert np.all(want[:, nv:] == 0.0)
    want = want[:, :nv]
    want = want[np.any(want != 0.0, axis=(1, 2))]
    got = got[np.any(got != 0.0, axis=(1, 2))]
    assert got.shape == want.shape and got.shape[0] > 0
    assert_close(got, want, RTOL, "dense constraint rows")


@pytest.mark.parametrize("context", ["minimize", "mesh_operation", "finalize"])
def test_geometric_enforcement_matches_jax(lane, context):
    jp, tspec, topo, params = lane
    js, ts = _states(jp, True)
    want = jcore.make_constraint_enforcer(jp.spec)(js, jp.topo, jp.params, context=context)
    got = tcore.make_constraint_enforcer(tspec)(ts, topo, params, context=context)
    nv = jp.n_vertices
    assert_close(got.positions, np.asarray(want.positions)[:nv], RTOL, "positions")


def test_tilt_enforcement_full_and_frozen_match_jax(lane):
    jp, tspec, topo, params = lane
    js, ts = _states(jp, True)
    nv = jp.n_vertices
    want = jrelax.make_tilt_enforcer(jp.spec)(js, jp.topo, jp.params)
    got = trelax.make_tilt_enforcer(tspec)(ts, topo, params)
    for name in ("tilts_in", "tilts_out"):
        assert_close(getattr(got, name), np.asarray(getattr(want, name))[:nv], RTOL, name)

    _e, _f, jc_pre, jc_fns, _n = jrelax.collect_frozen_tilt_program(jp.spec)
    _e, _f, tc_pre, tc_fns, _n = trelax.collect_frozen_tilt_program(tspec)
    assert len(jc_fns) == len(tc_fns) == 2
    jin, jout = js.tilts_in, js.tilts_out
    tin, tout = ts.tilts_in, ts.tilts_out
    for jpre, jfn, tpre, tfn in zip(jc_pre, jc_fns, tc_pre, tc_fns):
        jin, jout = jfn(jin, jout, jpre(js, jp.topo, jp.params), jp.topo, jp.params)
        tin, tout = tfn(tin, tout, tpre(ts, topo, params), topo, params)
    assert_close(tin, np.asarray(jin)[:nv], RTOL, "frozen tilts_in")
    assert_close(tout, np.asarray(jout)[:nv], RTOL, "frozen tilts_out")
    # the frozen split reproduces the full enforcement
    assert_close(tin, got.tilts_in, 1e-14, "frozen vs full tilts_in")


def test_compact_tilt_projector_matches_jax(lane):
    jp, tspec, topo, params = lane
    js, ts = _states(jp, True)
    nv = jp.n_vertices
    rng = np.random.default_rng(8)
    gin = np.zeros((jp.spec.nv_cap, 3))
    gout = np.zeros((jp.spec.nv_cap, 3))
    gin[:nv] = rng.standard_normal((nv, 3))
    gout[:nv] = rng.standard_normal((nv, 3))
    jcompact = jrelax.make_compact_tilt_collector(jp.spec)(js, jp.topo, jp.params)
    want = jrelax.make_compact_tilt_projector(jcompact, n_rows=jp.spec.nv_cap)(
        jnp.asarray(gin), jnp.asarray(gout)
    )
    tcompact = trelax.make_compact_tilt_collector(tspec)(ts, topo, params)
    got = trelax.make_compact_tilt_projector(tcompact, nv)(
        torch.as_tensor(gin[:nv]), torch.as_tensor(gout[:nv])
    )
    for g, w, name in zip(got, want, ("in", "out")):
        assert_close(g, np.asarray(w)[:nv], RTOL, f"projected g_{name}")
    # the projected gradient is orthogonal to every constraint row
    vals, rows, leaf, bgs = tcompact
    g2 = torch.stack(got)
    resid = torch.einsum("iac,iac->i", vals, g2[leaf, rows])
    for c, f in bgs:
        resid = resid + c * torch.sum(f * g2)
    assert float(torch.max(torch.abs(resid))) < 1e-12


def test_jacobi_preconditioner_matches_jax(lane):
    jp, _tspec, topo, params = lane
    js, ts = _states(jp, True)
    want = jrelax.jacobi_preconditioner(js.positions, jp.topo, jp.params)
    got = trelax.jacobi_preconditioner(ts.positions, topo, params)
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w)[: jp.n_vertices], RTOL, "jacobi")


def test_negated_rows_give_zero_multipliers_without_raising():
    """An exactly singular KKT system (rows r and -r): the projection is skipped."""
    rng = np.random.default_rng(1)
    r = rng.standard_normal((6, 3))
    rows = np.stack([r, -r])
    G = rows.reshape(2, -1)
    A = G @ G.T + 1e-18 * np.eye(2)
    b = G @ rng.standard_normal(18)
    lam_j = np.asarray(jcore._solve_kkt_with_rescue(jnp.asarray(A), jnp.asarray(b), 2))
    lam_t = tcore.solve_kkt_with_rescue(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_array_equal(lam_j, np.zeros(2))
    np.testing.assert_array_equal(lam_t.numpy(), np.zeros(2))
    grad = rng.standard_normal((6, 3))
    out = tcore.project_gradient_kkt(torch.as_tensor(grad), torch.as_tensor(rows))
    np.testing.assert_array_equal(out.numpy(), grad)
    want = jcore.project_gradient_kkt(jnp.asarray(grad), jnp.asarray(rows))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_dense_projection_matches_jax():
    """The dense channel (several rows) against the JAX solve."""
    rng = np.random.default_rng(6)
    rows = rng.standard_normal((4, 10, 3))
    grad = rng.standard_normal((10, 3))
    want = jcore.project_gradient_kkt(jnp.asarray(grad), jnp.asarray(rows))
    got = tcore.project_gradient_kkt(torch.as_tensor(grad), torch.as_tensor(rows))
    assert_close(got, want, RTOL, "dense projection")
