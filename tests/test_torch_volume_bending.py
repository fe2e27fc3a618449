"""The vesicle lane's modules against the JAX package at float64, rel 1e-12.

``volume`` (the penalty energy, the Lagrange KKT rows, the geometric
projection at its 3 and 12 iterations, fixed vertices), ``bending``
(helfrich and willmore, per-vertex kappa and c0, on the closed cube and on
the spherical cap, which has a boundary), ``gaussian_curvature`` (meshgen
``spherical_cap`` and the closed cube), the compiled tables, and the
minimizer's post-step volume drift check.  Both packages evaluate the same
seeded perturbed state of the same compiled problem.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_port_harness import (
    assert_close,
    make_vesicle_minimizer,
    perturbed_pair,
    port_from_jax,
    vesicle_data,
)

from membrane_solver_tpu.constraints import get_constraint as jget_constraint
from membrane_solver_tpu.device import geo as jgeo
from membrane_solver_tpu.energy import get_module as jget_module
from membrane_solver_tpu.runtime import jit_core as jcore
from membrane_solver_tpu_torch.constraints import get_constraint as tget_constraint
from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.energy import get_module as tget_module
from membrane_solver_tpu_torch.runtime import jit_core as tcore

RTOL = 1e-12


def _with_vertex_options(data, every: int = 3):
    """Per-vertex bending overrides on every ``every``-th vertex."""
    for i, vertex in enumerate(data["vertices"]):
        if i % every:
            continue
        opts = dict(vertex[3]) if len(vertex) > 3 and isinstance(vertex[3], dict) else {}
        opts.update({"bending_modulus": 1.0 + 0.25 * i, "spontaneous_curvature": 0.1 * i})
        data["vertices"][i] = list(vertex[:3]) + [opts]
    return data


def _cap_data(port: bool, **gp):
    from_pkg = "membrane_solver_tpu_torch" if port else "membrane_solver_tpu"
    build = __import__(f"{from_pkg}.meshgen", fromlist=["build"]).build
    data = build("spherical_cap")
    data.pop("instructions", None)
    data["energy_modules"] = ["surface", "bending", "gaussian_curvature"]
    data["global_parameters"].update({"bending_modulus": 0.8, "gaussian_modulus": 0.3, **gp})
    return data


def _pair(kind: str, refines: int = 1, **gp):
    """(JAX minimizer, port minimizer) of one small lane."""
    if kind == "cube":
        datas = [vesicle_data(port) for port in (False, True)]
    elif kind == "cube_kappa":
        datas = [_with_vertex_options(vesicle_data(port)) for port in (False, True)]
    elif kind == "cap":
        datas = [_cap_data(port) for port in (False, True)]
        refines = 0
    else:
        raise ValueError(kind)
    for d in datas:
        if "gaussian_curvature" not in d["energy_modules"]:
            d["energy_modules"].append("gaussian_curvature")
        d["global_parameters"].update({"gaussian_modulus": 0.3, **gp})
    if kind == "cap":
        return tuple(make_vesicle_minimizer(port, 0, data=d) for port, d in zip((False, True), datas))
    return tuple(make_vesicle_minimizer(port, refines, data=d) for port, d in zip((False, True), datas))


@pytest.fixture(scope="module", params=["cube", "cube_kappa", "cap"])
def lane(request):
    jm, tm = _pair(request.param)
    jp = jm.problem()
    _state, topo, params = port_from_jax(jp)
    jstate, tstate = perturbed_pair(jp, seed=5)
    return jp, tm.problem().spec, topo, params, jstate, tstate


def _module_value_and_grad(fn, js, jp):
    def f(pos):
        st = dataclasses.replace(js, positions=pos)
        geo = jgeo.triangle_geometry(pos, jp.topo.tri_rows, jp.topo.tri_valid)
        return fn(geo, st, jp.topo, jp.params)

    E, g = jax.value_and_grad(f)(js.positions)
    return float(E), np.asarray(g)[: jp.n_vertices]


def _port_value_and_grad(fn, ts, topo, params):
    x = ts.positions.clone().requires_grad_(True)
    st = dataclasses.replace(ts, positions=x)
    E = fn(tgeo.triangle_geometry(x, topo.tri_rows, topo.tri_valid), st, topo, params)
    if not E.requires_grad:
        return float(E), torch.zeros_like(x)
    (g,) = torch.autograd.grad(E, (x,))
    return float(E.detach()), g


def _fns(name, jspec, tspec, **opts):
    jmod, tmod = jget_module(name), tget_module(name)
    jspec = dataclasses.replace(jspec, static_options=tuple(opts.items()))
    tspec = dataclasses.replace(tspec, static_options=tuple(opts.items()))
    jfn = jmod.make_energy(jspec) if hasattr(jmod, "make_energy") else jmod.energy
    tfn = tmod.make_energy(tspec) if hasattr(tmod, "make_energy") else tmod.energy
    return jfn, tfn


@pytest.mark.parametrize("model", ["helfrich", "willmore"])
def test_bending_energy_and_gradient_match_jax(lane, model):
    jp, tspec, topo, params, js, ts = lane
    jfn, tfn = _fns("bending", jp.spec, tspec, bending_energy_model=model)
    jE, jg = _module_value_and_grad(jfn, js, jp)
    tE, tg = _port_value_and_grad(tfn, ts, topo, params)
    assert tE == pytest.approx(jE, rel=RTOL)
    assert jE > 0.0
    assert_close(tg, jg, RTOL, f"bending {model} gradient")


@pytest.mark.parametrize("name", ["surface", "volume"])
def test_surface_and_volume_penalty_match_jax(lane, name):
    jp, tspec, topo, params, js, ts = lane
    jspec = dataclasses.replace(jp.spec, volume_mode="penalty")
    jfn, tfn = _fns(name, jspec, dataclasses.replace(tspec, volume_mode="penalty"))
    jE, jg = _module_value_and_grad(jfn, js, jp)
    tE, tg = _port_value_and_grad(tfn, ts, topo, params)
    assert tE == pytest.approx(jE, rel=RTOL, abs=1e-300)
    assert_close(tg, jg, RTOL, f"{name} gradient", atol_scale=1e-300)


def test_gaussian_curvature_matches_jax(lane):
    """Closed cube: 2 pi kappa_bar chi; spherical cap: kappa_bar * Gauss-Bonnet total."""
    jp, tspec, topo, params, js, ts = lane
    jfn, tfn = jget_module("gaussian_curvature").energy, tget_module("gaussian_curvature").energy
    jE = float(jfn(None, js, jp.topo, jp.params))
    tE, tg = _port_value_and_grad(tfn, ts, topo, params)
    assert tE == pytest.approx(jE, rel=RTOL)
    assert float(torch.max(torch.abs(tg))) == 0.0
    has_boundary = bool(topo.extras["energy:gaussian_curvature/has_boundary"])
    assert has_boundary == bool(topo.boundary_vertex_mask.any())


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "boundary_masked"])
def test_angle_defects_match_jax(lane, masked):
    """Integrated Gaussian curvature per vertex, with and without the boundary mask."""
    jp, _tspec, topo, _params, js, ts = lane
    want = jgeo.angle_defects(js.positions, jp.topo.tri_rows, jp.topo.tri_valid,
                              jp.topo.vertex_valid,
                              jp.topo.boundary_vertex_mask if masked else None)
    got = tgeo.angle_defects(ts.positions, topo.tri_rows, topo.tri_valid, topo.vertex_valid,
                             topo.corner_csr(), topo.boundary_vertex_mask if masked else None)
    assert_close(got, np.asarray(want)[: jp.n_vertices], RTOL, "angle defects", atol_scale=1.0)
    assert float(torch.max(torch.abs(got))) > 0.0


def test_gaussian_curvature_closed_surface_is_topological():
    jm, tm = _pair("cube")
    jE, tE = jm.compute_energy_breakdown(), tm.compute_energy_breakdown()
    assert tE["gaussian_curvature"] == pytest.approx(jE["gaussian_curvature"], rel=RTOL)
    # closed genus-0 shell: 2 pi kappa_bar chi with chi = 2
    assert tE["gaussian_curvature"] == pytest.approx(2.0 * np.pi * 0.3 * 2.0, rel=RTOL)


def test_compiled_bending_and_body_tables_match_jax(lane):
    jp, _tspec, topo, _params, _js, _ts = lane
    for key in ("has_kappa", "kappa", "has_c0", "c0"):
        want = np.asarray(jp.topo.extras[f"energy:bending/{key}"])[: jp.n_vertices]
        np.testing.assert_array_equal(topo.extras[f"energy:bending/{key}"].numpy(), want)


def test_port_compiles_the_same_tables_as_jax():
    jm, tm = _pair("cube_kappa")
    jp, tp = jm.problem(), tm.problem()
    _state, topo, _params = port_from_jax(jp)
    assert set(tp.topo.extras) == set(topo.extras)
    for key, arr in tp.topo.extras.items():
        assert torch.equal(arr, topo.extras[key]), key
    for name in ("tri_body", "body_valid", "body_target_volume", "body_has_target",
                 "body_volume_stiffness", "fixed_mask"):
        assert torch.equal(getattr(tp.topo, name), getattr(topo, name)), name
    assert bool(tp.topo.extras["energy:bending/has_kappa"].any())
    assert tp.spec.volume_mode == jp.spec.volume_mode == "lagrange"
    assert tp.spec.volume_projection_during_minimization is True


@pytest.fixture(scope="module", params=[False, True], ids=["free", "fixed"])
def volume_lane(request):
    data = [vesicle_data(port) for port in (False, True)]
    if request.param:
        for d in data:  # pin two cube corners
            for i in (0, 6):
                d["vertices"][i] = list(d["vertices"][i][:3]) + [{"fixed": True}]
    jm, tm = (make_vesicle_minimizer(port, 1, data=d) for port, d in zip((False, True), data))
    jp = jm.problem()
    _state, topo, params = port_from_jax(jp)
    assert bool(topo.fixed_mask.any()) == request.param
    jstate, tstate = perturbed_pair(jp, seed=9)
    return jp, topo, params, jstate, tstate, tm.problem().spec


def test_volume_constraint_rows_match_jax(volume_lane):
    jp, topo, params, js, ts, _tspec = volume_lane
    want = np.asarray(jget_constraint("volume").constraint_gradient_rows(js, jp.topo, jp.params))
    got = tget_constraint("volume").constraint_gradient_rows(ts, topo, params)
    assert got.shape[0] == want.shape[0] == 1
    assert_close(got, want[:, : jp.n_vertices], RTOL, "volume rows")


@pytest.mark.parametrize("context", ["minimize", "mesh_operation"])
def test_volume_enforce_matches_jax(volume_lane, context):
    """3 iterations in the minimize context, 12 otherwise; fixed rows stay put."""
    jp, topo, params, js, ts, _tspec = volume_lane
    want = jget_constraint("volume").enforce(js, jp.topo, jp.params, context=context)
    got = tget_constraint("volume").enforce(ts, topo, params, context=context)
    assert_close(got.positions, np.asarray(want.positions)[: jp.n_vertices], RTOL, "positions")
    fixed = topo.fixed_mask
    assert torch.equal(got.positions[fixed], ts.positions[fixed])
    vol = float(tgeo.body_volumes(got.positions, topo.tri_rows, topo.tri_valid, topo.tri_body, 1)[0])
    start = float(tgeo.body_volumes(ts.positions, topo.tri_rows, topo.tri_valid, topo.tri_body, 1)[0])
    assert abs(vol - 1.0) < abs(start - 1.0)
    if context == "mesh_operation":
        assert vol == pytest.approx(1.0, abs=1e-10)


def test_body_volumes_match_jax(volume_lane):
    jp, topo, _params, js, ts, _tspec = volume_lane
    want = jgeo.body_volumes(js.positions, jp.topo.tri_rows, jp.topo.tri_valid, jp.topo.tri_body,
                             jp.spec.nb_cap)
    got = tgeo.body_volumes(ts.positions, topo.tri_rows, topo.tri_valid, topo.tri_body,
                            topo.body_valid.shape[0])
    assert_close(got, np.asarray(want)[: got.shape[0]], RTOL, "body volumes")


def test_projected_gradient_matches_jax(volume_lane):
    """The single dense volume row through the KKT projector."""
    jp, topo, params, js, ts, tspec = volume_lane
    jfn = jcore.make_gradient_projector(jp.spec)
    tfn = tcore.make_gradient_projector(tspec)
    rng = np.random.default_rng(4)
    g = rng.standard_normal(np.asarray(js.positions).shape)
    want = np.asarray(jfn(jax.numpy.asarray(g), js, jp.topo, jp.params))[: jp.n_vertices]
    got = tfn(torch.as_tensor(g[: jp.n_vertices]), ts, topo, params)
    assert_close(got, want, RTOL, "projected gradient")


@pytest.mark.parametrize("proj", [True, False], ids=["projection", "drift_check"])
def test_three_steps_match_jax_with_volume_modes(proj):
    """Per-trial projection (the lane's mode) and the post-step drift check.

    ``volume_projection_during_minimization`` off turns the per-trial
    volume projection off and the drift check on; a tiny
    ``volume_tolerance`` makes every accepted step take the hard projection.
    """
    gp = {"volume_projection_during_minimization": proj}
    if not proj:
        gp["volume_tolerance"] = 1e-12
    jm, tm = _pair("cube", **gp)
    for step in range(3):
        rj, rt = jm.minimize(1), tm.minimize(1)
        assert rt["energy"] == pytest.approx(rj["energy"], rel=1e-10), step
        assert rt["step_success"] == rj["step_success"], step
    np.testing.assert_allclose(tm.mesh.positions_array(), jm.mesh.positions_array(),
                               rtol=0, atol=1e-10)
    p = tm.problem()
    vol = float(tgeo.body_volumes(p.state.positions, p.topo.tri_rows, p.topo.tri_valid,
                                  p.topo.tri_body, 1)[0])
    if not proj and rt["step_success"]:
        # the accepted step drifted past 1e-12 and took the 12-iteration projection
        assert vol == pytest.approx(1.0, abs=1e-10)


def test_drift_check_option_follows_the_volume_mode(monkeypatch):
    seen = []
    real = tcore.minimize_block

    def spy(spec, options):
        seen.append(options)
        return real(spec, options)

    monkeypatch.setattr(tcore, "minimize_block", spy)
    for proj in (True, False):
        _jm, tm = _pair("cube", volume_projection_during_minimization=proj)
        tm.minimize(1)
    assert [o.volume_drift_check for o in seen] == [False, True]
    assert all(o.enforce_in_line_search for o in seen)


@pytest.mark.parametrize(
    "key", ["gaussian_curvature_check_defects", "gaussian_curvature_strict_topology"]
)
def test_gauss_bonnet_validation_switches_raise(key):
    """The JAX package validates the topology under these switches; the port refuses them."""
    _jm, tm = _pair("cube", **{key: True})
    with pytest.raises(NotImplementedError, match=key):
        tm.minimize(1)
