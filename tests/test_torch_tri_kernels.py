"""The per-triangle kernels' plain twins and wrappers against the JAX package.

Three groups, on the JAX kernel tests' seeded inputs (T = 200 triangles,
the last 7 invalid):

- each twin against the JAX package's Pallas function in interpret mode
  (the JAX tests' CPU route) at float32, with that file's tolerances:
  surface energy rel 2e-6, corner gradients rel 2e-5; curvature and
  divergence rel 5e-5, atol 1e-5;
- each twin against the stock ``geo`` / ``tilt_ops`` functions at float64
  to 1e-12, and the curvature backward (autograd of the twin) against
  ``jax.vjp`` of the per-triangle part of ``geo.curvature_data``;
- the whole-call entry points, each one call each way with the corner-CSR
  vertex sums, against the JAX package at float64 to 1e-12, on the seeded
  set and on the small kozlov and vesicle meshes with seeded perturbations:
  ``tri_kernels.curvature_data`` and its backward against the stock
  ``geo.curvature_data`` and ``jax.vjp``; ``tri_kernels.surface_energy``
  (tension mask and sum inside) and its gradient against
  ``energy/surface.energy`` and ``jax.grad``, with mixed tensions and
  invalid triangles; ``tri_kernels.p1_triangle_divergence`` (masks inside)
  against ``tilt_ops.p1_triangle_divergence`` and its tilt ``jax.vjp``;
- the wrappers: the CPU path runs the twins and launches nothing, the
  launchers refuse CPU tensors, the divergence refuses differentiable
  positions; and, on a card only, each CUDA kernel against its twin.

The Pallas surface kernel's corner gradients are the negated area gradient
(its cross product takes the edge first; it is called from no solver
path), so the twin's gradients are held against minus them and against
``jax.grad`` of the stock surface energy.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import SMALL, assert_close, make_minimizer, make_vesicle_minimizer

from membrane_solver_tpu.device import geo as jgeo
from membrane_solver_tpu.device import tilt_ops as jtops
from membrane_solver_tpu.energy import surface as jsurface
from membrane_solver_tpu.pallas_kernels import (
    curvature_corners_pallas,
    p1_divergence_pallas,
    surface_corner_grads_pallas,
)
from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.device import tilt_ops as ttops
from membrane_solver_tpu_torch.device.state import corner_csr
from membrane_solver_tpu_torch.kernels import _build
from membrane_solver_tpu_torch.kernels import tri_kernels as tk
from membrane_solver_tpu_torch.kernels import vertex_sum as vs

F64_RTOL = 1e-12
GAMMA = 1.7


def _inputs(dtype, T=200, Nv=90, seed=11):
    """The JAX kernel tests' triangles: (positions, tri_rows, valid, tilts) as numpy."""
    rng = np.random.default_rng(seed)
    tri_rows = rng.integers(0, Nv, size=(T, 3))
    tri_rows[:, 1] = (tri_rows[:, 0] + 1 + tri_rows[:, 1] % (Nv - 2)) % Nv
    tri_rows[:, 2] = (tri_rows[:, 1] + 1 + tri_rows[:, 2] % (Nv - 2)) % Nv
    positions = rng.standard_normal((Nv, 3)).astype(dtype)
    tilts = (0.3 * rng.standard_normal((Nv, 3))).astype(dtype)
    valid = np.ones(T, dtype=bool)
    valid[-7:] = False
    return positions, tri_rows, valid, tilts


def _torch(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _corners_np(x, rows):
    return [x[rows[:, i]] for i in range(3)]


# ----------------------------------------------------------------------
# twins vs the JAX Pallas kernels (interpret mode), float32
# ----------------------------------------------------------------------
def test_surface_twin_matches_pallas_f32():
    pos, rows, valid, _ = _inputs(np.float32)
    gamma = np.where(valid, np.float32(GAMMA), np.float32(0.0))
    want = surface_corner_grads_pallas(*map(jnp.asarray, _corners_np(pos, rows)), jnp.asarray(gamma))
    got = tgeo.surface_corner_terms(*_torch(*_corners_np(pos, rows)), torch.as_tensor(gamma))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-6, atol=1e-7)
    for g_port, g_pallas in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g_port.numpy(), -np.asarray(g_pallas), rtol=2e-5, atol=1e-6)


def test_curvature_twin_matches_pallas_f32():
    pos, rows, valid, _ = _inputs(np.float32)
    want = curvature_corners_pallas(*map(jnp.asarray, _corners_np(pos, rows)), jnp.asarray(valid))
    got = tgeo.curvature_corners(*_torch(*_corners_np(pos, rows)), torch.as_tensor(valid))
    # per-corner values compared as the JAX tests do: scattered to vertices,
    # where a cotangent near a branch tie cannot pick a different Meyer branch
    nv = pos.shape[0]
    t_rows = torch.as_tensor(rows)
    j_rows = jnp.asarray(rows, jnp.int32)
    for i, name in ((1, "k0"), (2, "k1"), (3, "k2")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=5e-5, atol=1e-5,
                                   err_msg=name)
    k_port = tgeo.scatter_add_rows(got[1], got[2], got[3], corner_csr(t_rows, nv))
    k_pallas = jgeo.scatter_add_rows(want[1], want[2], want[3], j_rows, nv)
    np.testing.assert_allclose(k_port.numpy(), np.asarray(k_pallas), rtol=5e-5, atol=1e-5)
    va_port = tgeo.scatter_add_rows(got[4][:, 0], got[4][:, 1], got[4][:, 2], corner_csr(t_rows, nv))
    va_pallas = jgeo.scatter_add_rows(want[4][:, 0], want[4][:, 1], want[4][:, 2], j_rows, nv)
    np.testing.assert_allclose(va_port.numpy(), np.asarray(va_pallas), rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]), rtol=5e-5, atol=1e-5)


def test_p1_divergence_twin_matches_pallas_f32():
    pos, rows, _valid, tilts = _inputs(np.float32)
    args = _corners_np(pos, rows) + _corners_np(tilts, rows)
    want = p1_divergence_pallas(*map(jnp.asarray, args))
    got = ttops.p1_divergence_corners(*_torch(*args))
    for g, w, name in zip(got, want, ("div", "area", "g0", "g1", "g2")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=1e-5, err_msg=name)


# ----------------------------------------------------------------------
# twins vs the stock JAX functions, float64
# ----------------------------------------------------------------------
def test_surface_twin_matches_stock_area_and_its_gradient_f64():
    pos, rows, valid, _ = _inputs(np.float64)
    gamma = np.where(valid, GAMMA, 0.0)
    j_rows = jnp.asarray(rows, jnp.int32)

    def jax_energy(p):
        geo = jgeo.triangle_geometry(p, j_rows, jnp.asarray(valid))
        return jnp.sum(jnp.asarray(gamma) * geo.area)

    want_e_tri = gamma * np.asarray(jgeo.triangle_geometry(jnp.asarray(pos), j_rows,
                                                           jnp.asarray(valid)).area)
    want_grad = jax.grad(jax_energy)(jnp.asarray(pos))
    e, g0, g1, g2 = tgeo.surface_corner_terms(*_torch(*_corners_np(pos, rows)),
                                              torch.as_tensor(gamma))
    assert_close(e, want_e_tri, F64_RTOL, "e_tri")
    grad = tgeo.scatter_add_rows(g0, g1, g2, corner_csr(torch.as_tensor(rows), pos.shape[0]))
    assert_close(grad, want_grad, F64_RTOL, "surface gradient")


def test_surface_wrapper_gradient_matches_jax_grad_f64():
    pos, rows, valid, _ = _inputs(np.float64)
    tension = np.full(rows.shape[0], GAMMA)
    j_rows = jnp.asarray(rows, jnp.int32)
    gamma = jnp.asarray(np.where(valid, GAMMA, 0.0))
    want = jax.grad(lambda p: jnp.sum(gamma * jgeo.triangle_geometry(
        p, j_rows, jnp.asarray(valid)).area))(jnp.asarray(pos))
    x = torch.as_tensor(pos).requires_grad_(True)
    t_rows = torch.as_tensor(rows)
    e = tk.surface_energy(x, t_rows, torch.as_tensor(valid), torch.as_tensor(tension),
                          corner_csr(t_rows, pos.shape[0]))
    (got,) = torch.autograd.grad(2.0 * e, (x,))
    assert_close(got, 2.0 * np.asarray(want), F64_RTOL, "wrapper surface gradient")


def test_curvature_twin_matches_stock_curvature_data_f64():
    pos, rows, valid, _ = _inputs(np.float64)
    nv = pos.shape[0]
    jc = jgeo.curvature_data(jnp.asarray(pos), jnp.asarray(rows, jnp.int32), jnp.asarray(valid), nv)
    cot, k0, k1, k2, va, areas = tgeo.curvature_corners(*_torch(*_corners_np(pos, rows)),
                                                        torch.as_tensor(valid))
    t_rows = torch.as_tensor(rows)
    assert_close(cot, jc.weights, F64_RTOL, "cot", atol_scale=1.0)
    assert_close(va, jc.corner_areas, F64_RTOL, "va", atol_scale=1.0)
    assert_close(tgeo.scatter_add_rows(k0, k1, k2, corner_csr(t_rows, nv)), jc.k_vecs, F64_RTOL, "k",
                 atol_scale=1.0)
    assert_close(tgeo.scatter_add_rows(va[:, 0], va[:, 1], va[:, 2], corner_csr(t_rows, nv)),
                 jc.vertex_areas, F64_RTOL, "vertex areas", atol_scale=1.0)
    e1 = pos[rows[:, 0]] - pos[rows[:, 2]]
    e2 = pos[rows[:, 1]] - pos[rows[:, 0]]
    assert_close(areas, 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1), F64_RTOL, "tri areas")


def test_p1_divergence_twin_matches_stock_f64():
    pos, rows, valid, tilts = _inputs(np.float64)
    div, area, g0, g1, g2 = ttops.p1_divergence_corners(
        *_torch(*(_corners_np(pos, rows) + _corners_np(tilts, rows)))
    )
    j_rows = jnp.asarray(rows, jnp.int32)
    jdiv, jarea, jg = jtops.p1_triangle_divergence(
        jnp.asarray(pos), jnp.asarray(tilts), j_rows, jnp.asarray(valid)
    )
    live = torch.as_tensor(valid)
    assert_close(div[live], np.asarray(jdiv)[valid], F64_RTOL, "div", atol_scale=1.0)
    assert_close(area[live], np.asarray(jarea)[valid], F64_RTOL, "area")
    assert_close(torch.stack([g0, g1, g2], dim=1), jg, F64_RTOL, "g", atol_scale=1.0)
    # the port's p1_triangle_divergence keeps the stock function's masks
    tdiv, tarea, tg = ttops.p1_triangle_divergence(*_torch(pos, tilts, rows, valid))
    for got, want, name in zip((tdiv, tarea, tg), (jdiv, jarea, jg), ("div", "area", "g")):
        assert_close(got, want, F64_RTOL, name, atol_scale=1.0)


def _jax_curvature_per_triangle(corners, valid):
    """The per-triangle part of jax geo.curvature_data on unshared corners.

    ``corners`` (T, 3, 3): giving every triangle its own three vertex rows
    makes the scatter an identity, so k_vecs and vertex_areas are the corner
    vectors and corner areas.
    """
    T = corners.shape[0]
    pos = corners.reshape(3 * T, 3)
    rows = jnp.arange(3 * T, dtype=jnp.int32).reshape(T, 3)
    c = jgeo.curvature_data(pos, rows, valid, 3 * T)
    e1 = corners[:, 0] - corners[:, 2]
    e2 = corners[:, 1] - corners[:, 0]
    areas = 0.5 * jnp.maximum(jgeo.safe_norm(jnp.cross(e1, e2)), jgeo.EPS_AREA)
    return c.weights, c.k_vecs.reshape(T, 3, 3), c.corner_areas, areas


@pytest.mark.parametrize("case", ["random", "right_triangles"])
def test_curvature_backward_matches_jax_vjp_f64(case):
    """K3b's twin (autograd of curvature_corners) against jax.vjp, every output weighted."""
    pos, rows, valid, _ = _inputs(np.float64)
    corners = np.stack(_corners_np(pos, rows), axis=1)
    if case == "right_triangles":
        # dyadic right triangles: cotangent exactly 0 at one corner (the
        # refined cube's faces), the Meyer branch boundary
        corners = np.zeros_like(corners)
        corners[:, 1, 0] = 0.25
        corners[:, 2, 1] = 0.5
        corners += np.arange(corners.shape[0])[:, None, None] * 0.125
    T = corners.shape[0]
    rng = np.random.default_rng(3)
    cts = (rng.standard_normal((T, 3)), rng.standard_normal((T, 3, 3)),
           rng.standard_normal((T, 3)), rng.standard_normal(T))
    _out, vjp = jax.vjp(lambda c: _jax_curvature_per_triangle(c, jnp.asarray(valid)),
                        jnp.asarray(corners))
    (want,) = vjp(tuple(map(jnp.asarray, cts)))

    x = torch.as_tensor(corners.reshape(3 * T, 3)).requires_grad_(True)
    t_rows = torch.arange(3 * T).reshape(T, 3)
    cot, k0, k1, k2, va, areas = tk.curvature_corners(x, t_rows, torch.as_tensor(valid),
                                                      corner_csr(t_rows, 3 * T))
    g_cot, g_k, g_va, g_area = _torch(*cts)
    obj = (torch.sum(cot * g_cot) + torch.sum(torch.stack([k0, k1, k2], 1) * g_k)
           + torch.sum(va * g_va) + torch.sum(areas * g_area))
    (got,) = torch.autograd.grad(obj, (x,))
    assert_close(got.reshape(T, 3, 3), want, F64_RTOL, "curvature vjp", atol_scale=1.0)
    # the twin of the backward kernel, called directly, is the same product
    direct = tk.curvature_corners_vjp(x.detach(), t_rows, torch.as_tensor(valid),
                                      g_cot, g_k, g_va, g_area)
    assert torch.equal(direct, got.reshape(T, 3, 3))


@functools.lru_cache(maxsize=None)
def _lane_arrays(name):
    """(positions, tri_rows, tri_valid) of a small lane mesh, positions perturbed by a seed."""
    if name == "kozlov_L1":
        mn = make_minimizer(True, kw=SMALL, refines=1, dtype=torch.float64)
    else:
        mn = make_vesicle_minimizer(True, refines=1, dtype=torch.float64)
    p = mn.problem()
    pos = p.state.positions.numpy()
    pos = pos + 0.01 * np.random.default_rng(23).standard_normal(pos.shape)
    valid = p.topo.tri_valid.numpy().copy()
    valid[::17] = False  # some masked rows, as a leaflet's presence mask gives
    return pos, p.topo.tri_rows.numpy(), valid


@pytest.fixture(scope="module", params=["kozlov_L1", "vesicle_L1"])
def mesh_arrays(request):
    """(positions, tri_rows, tri_valid) of a small lane mesh, positions perturbed by a seed."""
    return _lane_arrays(request.param)


@pytest.fixture(scope="module", params=["seeded", "kozlov_L1", "vesicle_L1"])
def whole_call_arrays(request):
    """(positions, tri_rows, tri_valid, tilts, tension), float64: mixed tensions, some zero."""
    rng = np.random.default_rng(37)
    if request.param == "seeded":
        pos, rows, valid, tilts = _inputs(np.float64)
    else:
        pos, rows, valid = _lane_arrays(request.param)
        tilts = 0.3 * rng.standard_normal(pos.shape)
    tension = rng.uniform(0.5, 2.0, rows.shape[0])
    tension[::5] = 0.0
    return pos, rows, valid, tilts, tension


def test_curvature_data_matches_jax_stock_and_its_vjp_f64(mesh_arrays):
    """curvature_data and its backward (CSR vertex sums) against geo.curvature_data and jax.vjp."""
    pos, rows, valid = mesh_arrays
    nv, T = pos.shape[0], rows.shape[0]
    rng = np.random.default_rng(29)
    cts = (rng.standard_normal((nv, 3)), rng.standard_normal(nv), rng.standard_normal((T, 3)),
           rng.standard_normal((T, 3)))
    j_rows, j_valid = jnp.asarray(rows, jnp.int32), jnp.asarray(valid)

    def jax_data(p):
        c = jgeo.curvature_data(p, j_rows, j_valid, nv)
        return c.k_vecs, c.vertex_areas, c.weights, c.corner_areas

    want, vjp = jax.vjp(jax_data, jnp.asarray(pos))
    (want_grad,) = vjp(tuple(map(jnp.asarray, cts)))
    t_rows = torch.as_tensor(rows)
    x = torch.as_tensor(pos).requires_grad_(True)
    cd = tk.curvature_data(x, t_rows, torch.as_tensor(valid), corner_csr(t_rows, nv))
    got = (cd.k_vecs, cd.vertex_areas, cd.weights, cd.corner_areas)
    for g, w, name in zip(got, want, ("k_vecs", "vertex_areas", "weights", "corner_areas")):
        assert_close(g, w, F64_RTOL, name, atol_scale=1.0)
    (grad,) = torch.autograd.grad(sum(torch.sum(g * torch.as_tensor(c)) for g, c in zip(got, cts)),
                                  (x,))
    assert_close(grad, want_grad, F64_RTOL, "curvature_data vjp", atol_scale=1.0)


def test_curvature_data_backward_with_unused_outputs_f64(mesh_arrays):
    """Outputs left out of the loss pass no upstream: the same gradient as zero upstream."""
    pos, rows, valid = mesh_arrays
    t_rows, v = torch.as_tensor(rows), torch.as_tensor(valid)
    csr = corner_csr(t_rows, pos.shape[0])
    w = torch.as_tensor(np.random.default_rng(31).standard_normal((pos.shape[0], 3)))
    x = torch.as_tensor(pos).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(w * tk.curvature_data(x, t_rows, v, csr).k_vecs), (x,))
    y = torch.as_tensor(pos).requires_grad_(True)
    (want,) = torch.autograd.grad(torch.sum(w * tgeo.curvature_data(y, t_rows, v, csr).k_vecs), (y,))
    assert_close(got, want, F64_RTOL, "k_vecs-only gradient", atol_scale=1.0)
    direct = tk.curvature_data_vjp_reference(torch.as_tensor(pos), t_rows, v, csr, w, None, None,
                                             None)
    assert torch.equal(direct, got)


def test_surface_energy_matches_jax_energy_and_grad_f64(whole_call_arrays):
    """surface_energy (mask and sum inside, CSR vertex sum) against energy/surface.energy."""
    pos, rows, valid, _tilts, tension = whole_call_arrays
    j_rows, j_valid = jnp.asarray(rows, jnp.int32), jnp.asarray(valid)
    j_topo = types.SimpleNamespace(tri_surface_tension=jnp.asarray(tension))

    def jax_energy(p):
        return jsurface.energy(jgeo.triangle_geometry(p, j_rows, j_valid), None, j_topo, None)

    want_e, want_g = jax.value_and_grad(jax_energy)(jnp.asarray(pos))
    t_rows, v, ten = torch.as_tensor(rows), torch.as_tensor(valid), torch.as_tensor(tension)
    csr = corner_csr(t_rows, pos.shape[0])
    x = torch.as_tensor(pos).requires_grad_(True)
    e = tk.surface_energy(x, t_rows, v, ten, csr)
    (grad,) = torch.autograd.grad(e, (x,))
    assert e.shape == ()
    assert_close(e.detach(), np.asarray(want_e), F64_RTOL, "surface energy")
    assert_close(grad, want_g, F64_RTOL, "surface gradient")
    # the energy-only call and the twin called directly give the same bits
    assert torch.equal(tk.surface_energy(torch.as_tensor(pos), t_rows, v, ten, csr), e.detach())
    ref_e, ref_g = tk.surface_energy_reference(torch.as_tensor(pos), t_rows, v, ten, csr, True)
    assert torch.equal(ref_e, e.detach()) and torch.equal(ref_g, grad)


def test_p1_triangle_divergence_matches_jax_and_its_tilt_vjp_f64(whole_call_arrays):
    """p1_triangle_divergence (masks inside, weighted CSR sum backward) against JAX."""
    pos, rows, valid, tilts, _tension = whole_call_arrays
    assert not valid.all()
    j_rows, j_valid = jnp.asarray(rows, jnp.int32), jnp.asarray(valid)
    want, vjp = jax.vjp(lambda t: jtops.p1_triangle_divergence(jnp.asarray(pos), t, j_rows,
                                                               j_valid), jnp.asarray(tilts))
    ct = np.random.default_rng(41).standard_normal(rows.shape[0])
    (want_dt,) = vjp((jnp.asarray(ct), jnp.zeros_like(want[1]), jnp.zeros_like(want[2])))
    p, t_rows, v = torch.as_tensor(pos), torch.as_tensor(rows), torch.as_tensor(valid)
    a = torch.as_tensor(tilts).requires_grad_(True)
    csr = corner_csr(t_rows, pos.shape[0])
    got = tk.p1_triangle_divergence(p, a, t_rows, v, csr)
    # the port's plain function exactly, the JAX package's to round-off
    plain = ttops.p1_triangle_divergence(p, torch.as_tensor(tilts), t_rows, v)
    for g, q, w, name in zip(got, plain, want, ("div", "area", "g")):
        assert torch.equal(g.detach(), q), name
        assert_close(g.detach(), w, F64_RTOL, name, atol_scale=1.0)
    (dt,) = torch.autograd.grad(got[0], (a,), (torch.as_tensor(ct),))
    assert_close(dt, want_dt, F64_RTOL, "tilt vjp", atol_scale=1.0)
    assert torch.equal(dt, tk.p1_div_vjp_reference(got[2], v, torch.as_tensor(ct), csr))


# ----------------------------------------------------------------------
# wrappers and dispatch
# ----------------------------------------------------------------------
def test_cpu_wrappers_run_the_twins_and_launch_nothing():
    pos, rows, valid, tilts = _inputs(np.float64)
    p, t_rows, v, tl = _torch(pos, rows, valid, tilts)
    before, before_vs = dict(tk.LAUNCHES), dict(vs.LAUNCHES)
    corners = [p[t_rows[:, i]] for i in range(3)]
    tension = torch.full((t_rows.shape[0],), GAMMA, dtype=p.dtype)
    gamma = torch.where(v, tension, 0.0)
    csr = corner_csr(t_rows, p.shape[0])
    curv = tk.curvature_data(p, t_rows, v, csr)
    cot, k0, k1, k2, va, _area = tgeo.curvature_corners(*corners, v)
    # the vertex sums: the CSR-order twin, the plain geo function (the same order)
    want_curv = tgeo.curvature_data(p, t_rows, v, csr)
    assert_close(curv.k_vecs, want_curv.k_vecs, F64_RTOL, "k_vecs", atol_scale=1.0)
    assert_close(curv.vertex_areas, want_curv.vertex_areas, F64_RTOL, "vertex areas")
    for got, want in (
        ((tk.surface_energy(p, t_rows, v, tension, csr),),
         (torch.sum(tgeo.surface_corner_terms(*corners, gamma)[0]),)),
        (tk.curvature_corners(p, t_rows, v, csr), tgeo.curvature_corners(*corners, v)),
        ((curv.k_vecs, curv.vertex_areas, curv.weights, curv.corner_areas),
         (vs.reference(torch.stack([k0, k1, k2], 1), csr), vs.reference(va, csr), cot, va)),
        (tk.p1_triangle_divergence(p, tl, t_rows, v, csr),
         ttops.p1_triangle_divergence(p, tl, t_rows, v)),
    ):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert tk.workspace(types.SimpleNamespace(), p) is None  # no scratch off the card
    assert tk.LAUNCHES == before and vs.LAUNCHES == before_vs


def test_p1_divergence_gradient_reaches_the_tilts_only():
    pos, rows, valid, tilts = _inputs(np.float64)
    p, t_rows, v, tl = _torch(pos, rows, valid, tilts)
    csr = corner_csr(t_rows, p.shape[0])
    a = tl.clone().requires_grad_(True)
    div, *_rest = tk.p1_triangle_divergence(p, a, t_rows, v, csr)
    w = torch.linspace(-1.0, 1.0, div.shape[0], dtype=div.dtype)
    (got,) = torch.autograd.grad(torch.sum(w * div), (a,))
    b = tl.clone().requires_grad_(True)
    div_ad, *_r = ttops.p1_triangle_divergence(p, b, t_rows, v)
    (want,) = torch.autograd.grad(torch.sum(w * div_ad), (b,))
    assert_close(got, want, F64_RTOL, "tilt gradient")
    with pytest.raises(ValueError, match="frozen positions"):
        tk.p1_triangle_divergence(p.clone().requires_grad_(True), tl, t_rows, v, csr)


def test_launchers_refuse_cpu_tensors():
    """A launch never falls back: a tensor off the card is refused before any build."""
    pos, rows, valid, tilts = _torch(*_inputs(np.float64, T=4, Nv=6))
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_surface(pos, rows, torch.ones(4, dtype=pos.dtype))
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_curvature(pos, rows, valid)
    z = torch.zeros(4, 3, dtype=pos.dtype)
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_curvature_bwd(pos, rows, valid, z, z[:, :, None].expand(4, 3, 3), z, z[:, 0])
    csr = corner_csr(rows, pos.shape[0])
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_curvature_data(pos, rows, valid, csr)
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_curvature_data_bwd(pos, rows, valid, csr, pos, pos[:, 0], None, None)
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_surface_energy(pos, rows, valid, torch.ones(4, dtype=pos.dtype), csr,
                                 None, grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_p1_divergence(pos, tilts, rows, valid)
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_p1_div_bwd(torch.zeros(4, 3, 3, dtype=pos.dtype), valid, pos[:4, 0], csr)


def test_build_targets_hopper_without_contraction_and_is_keyed_by_source():
    flags = " ".join(tk.KERNEL.flags)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    path = tk.KERNEL.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("tri_kernels-")
    assert tk.SOURCE.is_file() and tk.SOURCE.suffix == ".cu"
    text = tk.SOURCE.read_text()
    for entry in ("tri_surface_fwd", "tri_curvature_fwd", "tri_curvature_bwd",
                  "tri_curvature_data", "tri_curvature_data_bwd", "tri_surface_energy",
                  "tri_p1_div", "tri_p1_div_bwd", "tri_tile_size"):
        assert f'extern "C" int {entry}(' in text
    assert '#include "vertex_sum.cuh"' in text and '#include "block_sum.cuh"' in text
    assert f"constexpr int kTile = {tk.TILE};" in text


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_match_twins(dtype):
    """Card only: each CUDA kernel against its twin at T = 200."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    pos, rows, valid, tilts = _inputs(np_dtype)
    p, t_rows, v, tl = _torch(pos, rows, valid, tilts, device="cuda")
    rtol = 1e-12 if dtype == torch.float64 else 5e-5
    corners = [p[t_rows[:, i]] for i in range(3)]
    gamma = torch.where(v, GAMMA, 0.0).to(dtype)
    e, g = tk.launch_surface(p, t_rows, gamma)
    want = tgeo.surface_corner_terms(*corners, gamma)
    assert_close(e, want[0], rtol, "surface e")
    assert_close(g, torch.stack(want[1:], 1), rtol, "surface g")
    cot, k, va, area = tk.launch_curvature(p, t_rows, v)
    want = tgeo.curvature_corners(*corners, v)
    live = torch.abs(want[0]) > 1e-6  # rows clear of a Meyer branch tie
    live = live.all(dim=1)
    for got, w, name in ((cot, want[0], "cot"), (k, torch.stack(want[1:4], 1), "k"),
                         (va, want[4], "va"), (area, want[5], "area")):
        assert_close(got[live], w[live], rtol, name, atol_scale=1.0)
    cts = [torch.randn(s, dtype=dtype, device="cuda") for s in ((200, 3), (200, 3, 3), (200, 3), (200,))]
    dp = tk.launch_curvature_bwd(p, t_rows, v, *cts)
    want = tk.curvature_corners_vjp(p, t_rows, v, *cts)
    assert_close(dp[live], want[live], rtol, "curvature bwd", atol_scale=1.0)
    # the curvature data: live-row corners and, where no row of a vertex is
    # at a tie, its sums; two calls give the same bits
    csr = corner_csr(t_rows, p.shape[0])
    got = tk.launch_curvature_data(p, t_rows, v, csr)
    assert all(torch.equal(a, b) for a, b in zip(got, tk.launch_curvature_data(p, t_rows, v, csr)))
    want = tk.curvature_data_reference(p, t_rows, v, csr)
    clear = torch.ones(p.shape[0], dtype=torch.bool, device="cuda")
    clear[t_rows[~live].reshape(-1)] = False
    for a, b, name, rows_ok in zip(got, want, ("cot", "va", "k_vecs", "vertex_areas"),
                                   (live, live, clear, clear)):
        assert_close(a[rows_ok], b[rows_ok], rtol, name, atol_scale=1.0)
    g_kv, g_va = torch.randn(p.shape[0], 3, dtype=dtype, device="cuda"), cts[2]
    dpos = tk.launch_curvature_data_bwd(p, t_rows, v, csr, g_kv, None, None, g_va)
    again = tk.launch_curvature_data_bwd(p, t_rows, v, csr, g_kv, None, None, g_va)
    assert torch.equal(dpos, again)
    want = tk.curvature_data_vjp_reference(p, t_rows, v, csr, g_kv, None, None, g_va)
    assert_close(dpos[clear], want[clear], rtol, "curvature data bwd", atol_scale=1.0)
    # the whole calls: surface energy (alone, with its gradient) and the
    # masked divergence with its tilt backward; repeats give the same bits
    tension = torch.linspace(0.5, 2.0, 200, dtype=dtype, device="cuda")
    ws = tk.Workspace(200, dtype, "cuda")
    e_only, _ = tk.launch_surface_energy(p, t_rows, v, tension, csr, ws, grad=False)
    e, dpos = tk.launch_surface_energy(p, t_rows, v, tension, csr, ws, grad=True)
    again = tk.launch_surface_energy(p, t_rows, v, tension, csr, ws, grad=True)
    assert torch.equal(e, again[0]) and torch.equal(dpos, again[1]) and torch.equal(e, e_only)
    want_e, want_g = tk.surface_energy_reference(p, t_rows, v, tension, csr, True)
    assert_close(e[0], want_e, 2e-6 if dtype == torch.float32 else rtol, "surface energy")
    assert_close(dpos, want_g, rtol, "surface vertex gradient")
    got = tk.launch_p1_divergence(p, tl, t_rows, v)
    want = ttops.p1_triangle_divergence(p, tl, t_rows, v)
    for a, b, name in zip(got, want, ("div", "area", "g")):
        assert_close(a, b, rtol, "masked " + name, atol_scale=1.0)
    ct = torch.randn(200, dtype=dtype, device="cuda")
    dt = tk.launch_p1_div_bwd(got[2], v, ct, csr)
    assert torch.equal(dt, tk.launch_p1_div_bwd(got[2], v, ct, csr))
    assert_close(dt, tk.p1_div_vjp_reference(got[2], v, ct, csr), rtol, "div bwd")
    torch.cuda.synchronize()
