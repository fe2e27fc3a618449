"""The single-field tilt lane in the port against the JAX package, on the CPU at float64.

- ``tilt``, ``tilt_smoothness`` (``ambient_v1`` and ``connection_v1``) and
  ``tilt_coupling`` (``difference``, ``sum``, the ``tilt_couping_mode``
  alias, and no mode): energy, shape gradient and the gradients in the
  three tilt fields on meshgen ``kozlov_1disk`` at the ``SMALL`` size, with
  the inputs that ``tools/record_module_parity.py`` draws for its
  ``kozlov_vertex`` lane (the same global parameters, a seeded 0.02 height
  jitter, seeded tilt fields of scale 0.05), within rel 1e-12 of the JAX
  package.  The recorded ``module_parity2/refmod2_kozlov_vertex_*``
  fixtures hold the NumPy reference's values on the reference's own
  109-vertex kozlov mesh, whose input file is not in this repository, so
  the port is held against the JAX package live on the same inputs (the
  JAX package holds those fixtures itself, in
  ``tests/test_module_parity_extended.py``).
- The smoothness term adds nothing to the shape gradient.
- ``make_relax_vertex_tilts`` (CG and GD), the leaflet relax's GD branch
  and its whole-energy path (CG with ``tilt_coupling``), step for step:
  the relax with a budget of k iterations, for every k up to 20, gives
  the JAX package's accepted count and tilts within 1e-12 of the tilt
  scale.
- ``rect_tilt_source`` at 10 x 4 and 40 x 16 through its recipe ``g5`` in
  both command layers: every command's energy within rel 1e-12, equal
  counts.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import (
    BENCH_GP,
    SMALL,
    assert_close,
    port_from_jax,
    recipe_trace,
    to_np,
)

from membrane_solver_tpu.device import geo as jgeo
from membrane_solver_tpu.energy import get_module as jget_module
from membrane_solver_tpu.runtime import tilt_relax as jrelax
from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.energy import get_module as tget_module
from membrane_solver_tpu_torch.runtime import tilt_relax as trelax

RTOL = 1e-12
ITERS = 20
STEP = 0.2
TOL = 1e-10
FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")

# tools/record_module_parity.py's moduli for the vertex lane, and the
# coupling modulus of tests/test_tilt_module_parity.py
VERTEX_GP = {
    "tilt_modulus": 0.9,
    "tilt_smoothness_modulus": 0.65,
    "tilt_rigidity": 0.9,
    "tilt_smoothness_rigidity": 0.65,
    "tilt_coupling_modulus": 1.7,
}
# (energy module, extra global parameters)
CASES = {
    "tilt": ("tilt", {}),
    "smoothness_ambient": ("tilt_smoothness", {"tilt_transport_model": "ambient_v1"}),
    "smoothness_connection": ("tilt_smoothness", {"tilt_transport_model": "connection_v1"}),
    "coupling_difference": ("tilt_coupling", {"tilt_coupling_mode": "difference"}),
    "coupling_sum": ("tilt_coupling", {"tilt_coupling_mode": "sum"}),
    "coupling_alias": ("tilt_coupling", {"tilt_couping_mode": "difference"}),
    "coupling_off": ("tilt_coupling", {}),
}


def _seeded_data(port: bool, modules, gp):
    """kozlov_1disk SMALL with ``modules`` added, the jitter and seeded tilts of the recorder."""
    if port:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.meshgen import build
    else:
        import membrane_solver_tpu as pkg
        from membrane_solver_tpu.meshgen import build
    mesh = pkg.parse_geometry(build("kozlov_1disk", **SMALL))
    mesh.global_parameters.update(gp)
    for name in modules:
        if name not in mesh.energy_modules:
            mesh.energy_modules.append(name)
    vids = sorted(mesh.vertices)
    rng = np.random.default_rng(31)
    for vid in vids:
        mesh.vertices[vid].position[2] += 0.02 * rng.standard_normal()
    for attr, seed in (("tilt_in", 21), ("tilt_out", 22), ("tilt", 23)):
        vals = 0.05 * np.random.default_rng(seed).standard_normal((len(vids), 3))
        for vid, row in zip(vids, vals):
            getattr(mesh.vertices[vid], attr)[:] = row
    return mesh


def _pair(modules, gp, energy_modules=None):
    """(JAX problem, the port's spec, state, topo, params) on identical inputs."""
    from membrane_solver_tpu import Minimizer as JMinimizer
    from membrane_solver_tpu_torch import Minimizer as TMinimizer

    jmesh = _seeded_data(False, modules, gp)
    tmesh = _seeded_data(True, modules, gp)
    if energy_modules is not None:
        jmesh.energy_modules[:] = energy_modules
        tmesh.energy_modules[:] = energy_modules
    jp = JMinimizer(jmesh, quiet=True).problem()
    tspec = TMinimizer(tmesh, device="cpu", dtype=torch.float64, quiet=True).problem().spec
    state, topo, params = port_from_jax(jp)
    return jp, tspec, state, topo, params


def _energy_fn(get_module, name, spec):
    mod = get_module(name)
    maker = getattr(mod, "make_energy", None)
    return maker(spec) if maker is not None else mod.energy


def _jax_value_and_grads(fn, jp):
    def f(*fields):
        st = dataclasses.replace(jp.state, **dict(zip(FIELDS, fields)))
        geo = jgeo.triangle_geometry(st.positions, jp.topo.tri_rows, jp.topo.tri_valid)
        return fn(geo, st, jp.topo, jp.params)

    E, grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(
        *(getattr(jp.state, k) for k in FIELDS))
    return float(E), [np.asarray(g)[: jp.n_vertices] for g in grads]


def _port_value_and_grads(fn, ts, topo, params):
    leaves = [getattr(ts, k).clone().requires_grad_(True) for k in FIELDS]
    st = dataclasses.replace(ts, **dict(zip(FIELDS, leaves)))
    geo = tgeo.triangle_geometry(st.positions, topo.tri_rows, topo.tri_valid)
    E = fn(geo, st, topo, params)
    if not E.requires_grad:
        return float(E), [None] * 4
    return float(E.detach()), list(torch.autograd.grad(E, leaves, allow_unused=True))


@pytest.mark.parametrize("case", list(CASES))
def test_energy_value_and_gradients_match_jax(case):
    name, extra = CASES[case]
    jp, tspec, ts, topo, params = _pair([name], {**VERTEX_GP, **extra})
    Ej, gj = _jax_value_and_grads(_energy_fn(jget_module, name, jp.spec), jp)
    Et, gt = _port_value_and_grads(_energy_fn(tget_module, name, tspec), ts, topo, params)
    assert Et == pytest.approx(Ej, rel=RTOL, abs=1e-15), case
    if case != "coupling_off":
        assert Ej != 0.0
    for got, want, field in zip(gt, gj, FIELDS, strict=True):
        got = np.zeros_like(want) if got is None else to_np(got)
        assert_close(got, want, RTOL, f"{case} d/d{field}", atol_scale=1e-300)


def test_smoothness_adds_nothing_to_the_shape_gradient():
    """The cotangents come from detached positions: no shape gradient, the same as JAX's zero."""
    name = "tilt_smoothness"
    _jp, tspec, ts, topo, params = _pair([name], VERTEX_GP)
    _E, grads = _port_value_and_grads(_energy_fn(tget_module, name, tspec), ts, topo, params)
    assert grads[0] is None  # autograd never reaches the positions
    assert float(torch.max(torch.abs(grads[1]))) > 0.0


def test_single_field_modules_are_ported():
    from membrane_solver_tpu_torch.energy import PORTED

    assert {"tilt", "tilt_smoothness", "tilt_coupling"} <= set(PORTED)


# ----------------------------------------------------------------------
# the relaxes, step for step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("solver", ["cg", "gd"])
def test_vertex_relax_matches_jax_step_for_step(solver):
    gp = {**VERTEX_GP, "tilt_solver": solver, "tilt_solve_mode": "nested"}
    jp, tspec, ts, topo, params = _pair([], gp, energy_modules=["surface", "tilt",
                                                                 "tilt_smoothness"])
    jrelax_fn = jrelax.make_relax_vertex_tilts(jp.spec)
    trelax_fn = trelax.make_relax_vertex_tilts(tspec)
    moved = 0.0
    for k in range(1, ITERS + 1):
        jout, jn = jrelax_fn(jp.state, jp.topo, jp.params, jnp.asarray(k, jnp.int32),
                             jnp.asarray(STEP), jnp.asarray(TOL))
        tout, tn = trelax_fn(ts, topo, params, k, STEP, TOL)
        assert tn == int(jn), (solver, k)
        want = np.asarray(jout.tilts)[: jp.n_vertices]
        assert_close(tout.tilts, want, RTOL, f"{solver} tilts after {k} iterations")
        moved = float(np.max(np.abs(want - np.asarray(jp.state.tilts)[: jp.n_vertices])))
    assert moved > 1e-3


@pytest.mark.parametrize(
    "solver,coupling", [("gd", False), ("cg", True)], ids=["gd", "cg-with-coupling"])
def test_leaflet_relax_matches_jax_step_for_step(solver, coupling):
    """The leaflet relax's GD branch, and its whole-energy path on the kozlov lane's modules.

    ``tilt_coupling`` has no frozen split, so with it the relax evaluates
    the whole tilt energy per iteration, in both packages.
    """
    gp = {**BENCH_GP, "tilt_solver": solver}
    modules = []
    if coupling:
        gp.update(VERTEX_GP, tilt_coupling_mode="difference")
        modules = ["tilt_coupling"]
    jp, tspec, ts, topo, params = _pair(modules, gp)
    assert (trelax.collect_frozen_tilt_program(tspec) is None) == coupling
    jrelax_fn = jax.jit(jrelax.make_relax_leaflet_tilts.__wrapped__(jp.spec))
    trelax_fn = trelax.make_relax_leaflet_tilts(tspec)
    for k in range(1, ITERS + 1):
        jout, jstats = jrelax_fn(jp.state, jp.topo, jp.params, jnp.asarray(k, jnp.int32),
                                 jnp.asarray(0.15), jnp.asarray(TOL))
        tout, tstats = trelax_fn(ts, topo, params, k, 0.15, TOL)
        assert tstats.accepted_steps == int(jstats.accepted_steps), k
        assert tstats.rejected == bool(jstats.rejected), k
        assert tstats.initial_energy == pytest.approx(float(jstats.initial_energy), rel=RTOL)
        assert tstats.final_energy == pytest.approx(float(jstats.final_energy), rel=RTOL)
        for field in ("tilts_in", "tilts_out"):
            assert_close(getattr(tout, field), np.asarray(getattr(jout, field))[: jp.n_vertices],
                         RTOL, f"{field} after {k} iterations")
    assert tstats.accepted_steps > 1
    if solver == "gd":
        assert tstats.initial_energy == 0.0  # the JAX package reports none for GD


# ----------------------------------------------------------------------
# the lane through both command layers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nx,ny", [(10, 4), (40, 16)])
def test_rect_tilt_source_recipe_matches_jax(nx, ny):
    got = recipe_trace(True, "rect_tilt_source", nx=nx, ny=ny)
    want = recipe_trace(False, "rect_tilt_source", nx=nx, ny=ny)
    assert [g[0] for g in got] == [w[0] for w in want] == ["g5"]
    for g, w in zip(got, want, strict=True):
        assert g[2:4] == w[2:4] == ((nx + 1) * (ny + 1), 2 * nx * ny)
        assert g[1] == pytest.approx(w[1], rel=RTOL)
        assert g[4] == w[4]
