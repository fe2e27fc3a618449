"""The port's compiled state and device geometry against the JAX package.

Every compiled array and every extras key of the port's ``compile_state``
must equal the JAX package's unpadded rows exactly (as handed over by
``problem_from_numpy``); the geometry functions must agree at float64 to
1e-12 of their scale, on the flat start and on a seeded perturbed state.
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
from membrane_solver_tpu.device import tilt_ops as jtops
from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.device import tilt_ops as ttops
from membrane_solver_tpu_torch.device.state import MeshState, Topology

GEO_RTOL = 1e-12

# tables of the pin modules' fit/slide group modes, which the port does not
# compile (the lane pins with the fixed mode only)
JAX_ONLY_EXTRAS = {
    "constraint:pin_to_circle/" + k
    for k in ("g_has_normal", "g_has_radius", "g_mode", "g_normal", "g_point",
              "g_preserve", "g_radius", "m_group", "m_rows", "m_valid", "m_vfixed")
} | {
    "constraint:pin_to_plane/" + k
    for k in ("group", "group_has_normal", "group_mode", "group_normal", "mode")
}


@pytest.fixture(scope="module", params=[0, 1], ids=["L0", "L1"])
def pair(request):
    """(JAX minimizer, port minimizer) on the small lane, refined 0 or 1 times."""
    return (
        make_minimizer(False, kw=SMALL, refines=request.param),
        make_minimizer(True, kw=SMALL, refines=request.param),
    )


def _equal(a, b, what):
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {tuple(a.shape)} != {tuple(b.shape)}"
    assert bool(torch.equal(a, b)), f"{what}: values differ"


def test_compiled_topology_matches_jax_unpadded_rows(pair):
    jm, tm = pair
    jp, tp = jm.problem(), tm.problem()
    state, topo, params = port_from_jax(jp)
    for f in dataclasses.fields(Topology):
        if f.name != "extras":
            _equal(getattr(tp.topo, f.name), getattr(topo, f.name), f.name)
    assert set(jp.topo.extras) - set(tp.topo.extras) == JAX_ONLY_EXTRAS
    assert set(tp.topo.extras) <= set(jp.topo.extras)
    for key, arr in tp.topo.extras.items():
        _equal(arr, topo.extras[key], key)
    for f in dataclasses.fields(MeshState):
        _equal(getattr(tp.state, f.name), getattr(state, f.name), f.name)
    assert sorted(tp.params) == sorted(params)
    for key, val in tp.params.items():
        _equal(val, params[key], key)
    assert (tp.n_vertices, tp.n_tris, tp.n_edges) == (jp.n_vertices, jp.n_tris, jp.n_edges)
    np.testing.assert_array_equal(tp.vertex_ids, jp.vertex_ids)


def test_problem_spec_matches_jax(pair):
    jm, tm = pair
    js, ts = jm.problem().spec, tm.problem().spec
    assert ts.energy_modules == js.energy_modules
    assert ts.constraint_modules == js.constraint_modules
    assert ts.static_options == js.static_options
    assert ts.extra_static == js.extra_static
    assert ts.volume_mode == js.volume_mode


def _geo_inputs(pair, perturbed):
    jm, _tm = pair
    jp = jm.problem()
    _state, topo, _params = port_from_jax(jp)
    if perturbed:
        jstate, tstate = perturbed_pair(jp, seed=11)
    else:
        jstate = jp.state
        tstate = port_from_jax(jp)[0]
    return jp, jstate, tstate, topo


@pytest.mark.parametrize("perturbed", [False, True], ids=["flat", "perturbed"])
def test_geometry_functions_match_jax(pair, perturbed):
    jp, js, ts, topo = _geo_inputs(pair, perturbed)
    nv, nf = jp.n_vertices, jp.n_tris
    jt = jp.topo
    jg = jgeo.triangle_geometry(js.positions, jt.tri_rows, jt.tri_valid)
    tg = tgeo.triangle_geometry(ts.positions, topo.tri_rows, topo.tri_valid)
    for name in ("normal", "double_area", "area", "unit_normal"):
        assert_close(getattr(tg, name), np.asarray(getattr(jg, name))[:nf], GEO_RTOL, name)
    assert_close(
        tgeo.barycentric_vertex_areas(tg, topo.tri_rows, nv),
        np.asarray(jgeo.barycentric_vertex_areas(jg, jt.tri_rows, jp.spec.nv_cap))[:nv],
        GEO_RTOL, "vertex areas",
    )
    assert_close(
        tgeo.vertex_normals(tg, topo.tri_rows, topo.tri_valid, nv),
        np.asarray(jgeo.vertex_normals(jg, jt.tri_rows, jt.tri_valid, jp.spec.nv_cap))[:nv],
        GEO_RTOL, "vertex normals",
    )
    assert_close(tgeo.p1_shape_gradients(tg), np.asarray(jgeo.p1_shape_gradients(jg))[:nf],
                 GEO_RTOL, "p1 gradients")
    jc = jgeo.curvature_data(js.positions, jt.tri_rows, jt.tri_valid, jp.spec.nv_cap)
    tc = tgeo.curvature_data(ts.positions, topo.tri_rows, topo.tri_valid, nv)
    for name, rows in (("k_vecs", nv), ("vertex_areas", nv), ("weights", nf),
                       ("corner_areas", nf)):
        assert_close(getattr(tc, name), np.asarray(getattr(jc, name))[:rows], GEO_RTOL, name,
                     atol_scale=1.0)
    jdiv = jtops.p1_triangle_divergence(js.positions, js.tilts_in, jt.tri_rows, jt.tri_valid)
    tdiv = ttops.p1_triangle_divergence(ts.positions, ts.tilts_in, topo.tri_rows, topo.tri_valid)
    for got, want, name in zip(tdiv, jdiv, ("div", "area", "g")):
        assert_close(got, np.asarray(want)[:nf], GEO_RTOL, name, atol_scale=1.0)
    assert float(tgeo.min_edge_length(ts.positions, topo.edge_rows, topo.edge_valid)) == (
        pytest.approx(float(jgeo.min_edge_length(js.positions, jt.edge_rows, jt.edge_valid)),
                      rel=GEO_RTOL)
    )


def test_scatter_add_rows_matches_jax():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 40, size=(300, 3))
    vals = [rng.standard_normal((300, 3)) for _ in range(3)]
    want = jgeo.scatter_add_rows(*map(jnp.asarray, vals), jnp.asarray(rows, jnp.int32), 40)
    got = tgeo.scatter_add_rows(*map(torch.as_tensor, vals), torch.as_tensor(rows), 40)
    assert_close(got, want, GEO_RTOL, "scatter_add_rows")


def test_safe_norm_value_and_gradient_at_zero():
    vecs = np.array([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0], [1e-13, 0.0, 0.0], [1.0, -2.0, 2.0]])
    w = np.array([0.5, 1.5, -2.0, 1.0])
    jv, jgrad = jax.value_and_grad(lambda v: jnp.sum(jgeo.safe_norm(v) * w))(jnp.asarray(vecs))
    x = torch.as_tensor(vecs).requires_grad_(True)
    tv = torch.sum(tgeo.safe_norm(x) * torch.as_tensor(w))
    (tgrad,) = torch.autograd.grad(tv, (x,))
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-15)
    assert np.all(np.isfinite(tgrad.numpy()))
    assert_close(tgrad, jgrad, 1e-15, "safe_norm grad")


@pytest.mark.parametrize("perturbed", [False, True], ids=["flat", "perturbed"])
def test_directional_norm_gradient_matches_jax(pair, perturbed):
    """|K| at the flat start (|K| = 0): the derivative follows the vertex normal."""
    jp, js, ts, topo = _geo_inputs(pair, perturbed)
    nv = jp.n_vertices
    jt = jp.topo
    rng = np.random.default_rng(2)
    w_np = rng.standard_normal(jp.spec.nv_cap)

    def jax_obj(pos):
        curv = jgeo.curvature_data(pos, jt.tri_rows, jt.tri_valid, jp.spec.nv_cap)
        g = jgeo.triangle_geometry(pos, jt.tri_rows, jt.tri_valid)
        vn = jgeo.vertex_normals(g, jt.tri_rows, jt.tri_valid, jp.spec.nv_cap)
        return jnp.sum(jgeo.directional_norm(curv.k_vecs, vn) * jnp.asarray(w_np))

    jval, jgrad = jax.value_and_grad(jax_obj)(js.positions)
    x = ts.positions.clone().requires_grad_(True)
    curv = tgeo.curvature_data(x, topo.tri_rows, topo.tri_valid, nv)
    g = tgeo.triangle_geometry(x, topo.tri_rows, topo.tri_valid)
    vn = tgeo.vertex_normals(g, topo.tri_rows, topo.tri_valid, nv)
    tval = torch.sum(tgeo.directional_norm(curv.k_vecs, vn) * torch.as_tensor(w_np[:nv]))
    (tgrad,) = torch.autograd.grad(tval, (x,))
    assert float(tval.detach()) == pytest.approx(float(jval), rel=1e-10, abs=1e-13)
    assert np.all(np.isfinite(tgrad.numpy()))
    assert_close(tgrad, np.asarray(jgrad)[:nv], GEO_RTOL, "directional_norm grad", atol_scale=1.0)
    if not perturbed:
        # the flat start: |K| of the interior vertices is zero up to round-off,
        # mostly below the float64 kink threshold, where the fallback normal
        # is taken
        interior = ~topo.boundary_vertex_mask
        k_mag = torch.linalg.vector_norm(curv.k_vecs.detach(), dim=1)
        assert float(torch.max(k_mag[interior])) < 1e-14
        assert int(torch.sum(k_mag[interior] <= tgeo.kink_threshold(torch.float64))) > 0
        assert float(torch.max(torch.abs(tgrad[interior, 2]))) > 0.0


def test_problem_from_numpy_drops_padding():
    """Capacity padding rows of the JAX arrays never reach the port."""
    jm = make_minimizer(False, kw=SMALL)
    jp = jm.problem()
    assert jp.spec.nv_cap > jp.n_vertices
    state, topo, _params = port_from_jax(jp)
    assert state.positions.shape == (jp.n_vertices, 3)
    assert topo.tri_rows.shape == (jp.n_tris, 3)
    assert bool(topo.vertex_valid.all()) and bool(topo.tri_valid.all())
    assert topo.tri_rows.dtype == torch.int64
