"""The leaflet tilt-field energies in the port against the JAX package, on the CPU.

The set-up is ``tests/test_module_gradients_fd.py``'s kozlov problem
(meshgen ``kozlov_1disk`` at the ``SMALL`` size, its global parameters,
module list, ring tags and seeded tilts; ``chip_smoke.drives_setup`` with
``tools/record_torch_port_fixture.kozlov_drives_protocol()``, the
protocol that ``chip_smoke.py`` phase 20 runs on the kozlov L3 mesh).
Both packages build it; the port evaluates the JAX package's compiled
arrays (``port_from_jax``), so both sides see identical inputs.  At
float64, within rel 1e-12 of the JAX package (round-off):

- each of the ten new energy modules: energy, shape gradient and the
  gradients in both leaflet tilt fields;
- the compile-topology extras (ring rows, edge tables, strengths, frames,
  Bessel parameters) that the port compiles from the mesh itself;
- the frozen splits of the smoothness modules against their full energy;
- the unified ``tilt_smoothness_leaflet`` against in + out;
- ``connection_v1`` for both smoothness modules and splay-twist, the
  twist term, ``vertex_recovered``, and the outer leaflet absent on the
  disk (``leaflet_out_absent_presets``);
- ``tilt_mass_mode`` consistent for ``tilt_in`` and ``tilt_out``.

At float32, the port's fused frozen-tilt energy with the smoothness folded
into its w columns (its CPU twin) against the JAX package's
``_build_fused_tilt_energy`` with its Pallas kernel in interpret mode, on
the kozlov lane's modules plus ``tilt_smoothness_{in,out}`` (also with the
outer leaflet absent on the disk, and under ``connection_v1``, which is not
folded): energy to rel 1e-6, vertex gradients to 5e-6 * max|g| (the
frozen-tilt kernel tests' bounds).
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
    perturbed_pair,
    port_from_jax,
    to_np,
)

from chip_smoke import drives_setup
from membrane_solver_tpu.device import geo as jgeo
from membrane_solver_tpu.energy import get_module as jget_module
from membrane_solver_tpu.runtime import tilt_relax as jrelax
from membrane_solver_tpu_torch.device import geo as tgeo
from membrane_solver_tpu_torch.energy import get_module as tget_module
from membrane_solver_tpu_torch.runtime import tilt_relax as trelax
from tools.record_torch_port_fixture import kozlov_drives_protocol

RTOL = 1e-12
FIELDS = ("positions", "tilts_in", "tilts_out")
PROTOCOL = kozlov_drives_protocol()
NEW_MODULES = PROTOCOL["modules"]
COMPILED = ["tilt_disk_target_in", "tilt_disk_target_out", "tilt_rim_source_in",
            "tilt_rim_source_out", "tilt_rim_source_bilayer", "tilt_disk_contact_in"]
ENERGY_RTOL = 1e-6  # the frozen-tilt kernel tests' bounds
GRAD_RTOL = 5e-6


def _mesh(port: bool, gp=None, modules=None):
    """The FD test's kozlov problem in one package, with extra global parameters and modules."""
    if port:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.meshgen import build
    else:
        import membrane_solver_tpu as pkg
        from membrane_solver_tpu.meshgen import build
    mesh = pkg.parse_geometry(build("kozlov_1disk", **SMALL))
    protocol = dict(PROTOCOL, global_parameters={**PROTOCOL["global_parameters"], **(gp or {})})
    if modules is not None:
        protocol["energy_modules"] = modules
    drives_setup(mesh, protocol)
    return mesh


def _pair(gp=None, modules=None, dtype=torch.float64):
    """(JAX problem, the port's own compiled problem, the port's state/topo/params from JAX's)."""
    from membrane_solver_tpu import Minimizer as JMinimizer
    from membrane_solver_tpu_torch import Minimizer as TMinimizer

    jp = JMinimizer(_mesh(False, gp, modules), quiet=True).problem()
    tp = TMinimizer(_mesh(True, gp, modules), device="cpu", dtype=dtype, quiet=True).problem()
    return jp, tp, port_from_jax(jp, dtype=dtype)


@pytest.fixture(scope="module")
def drives():
    return _pair()


def _energy_fn(get_module, name, spec):
    mod = get_module(name)
    maker = getattr(mod, "make_energy", None)
    return maker(spec) if maker is not None else mod.energy


def _jax_value_and_grads(fn, jp):
    def f(*fields):
        st = dataclasses.replace(jp.state, **dict(zip(FIELDS, fields)))
        geo = jgeo.triangle_geometry(st.positions, jp.topo.tri_rows, jp.topo.tri_valid)
        return fn(geo, st, jp.topo, jp.params)

    E, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(*(getattr(jp.state, k) for k in FIELDS))
    return float(E), [np.asarray(g)[: jp.n_vertices] for g in grads]


def _port_value_and_grads(fn, ts, topo, params):
    leaves = [getattr(ts, k).clone().requires_grad_(True) for k in FIELDS]
    st = dataclasses.replace(ts, **dict(zip(FIELDS, leaves)))
    geo = tgeo.triangle_geometry(st.positions, topo.tri_rows, topo.tri_valid)
    E = fn(geo, st, topo, params)
    grads = torch.autograd.grad(E, leaves, allow_unused=True) if E.requires_grad else [None] * 3
    return float(E.detach()), [np.zeros(tuple(x.shape)) if g is None else to_np(g)
                               for g, x in zip(grads, leaves)]


def _assert_module_matches(name, jp, tp, port_inputs, what=""):
    ts, topo, params = port_inputs
    Ej, gj = _jax_value_and_grads(_energy_fn(jget_module, name, jp.spec), jp)
    Et, gt = _port_value_and_grads(_energy_fn(tget_module, name, tp.spec), ts, topo, params)
    assert Ej != 0.0, f"{name}{what} is inactive"
    assert Et == pytest.approx(Ej, rel=RTOL), f"{name}{what}"
    for got, want, field in zip(gt, gj, FIELDS, strict=True):
        assert_close(got, want, RTOL, f"{name}{what} d/d{field}", atol_scale=1e-300)
    return gj


@pytest.mark.parametrize("name", NEW_MODULES)
def test_module_energy_and_gradients_match_jax(name, drives):
    jp, tp, port_inputs = drives
    gj = _assert_module_matches(name, jp, tp, port_inputs)
    # every module drives the tilts: a nonzero tilt gradient
    assert max(float(np.max(np.abs(g))) for g in gj[1:]) > 0.0


@pytest.mark.parametrize("name", COMPILED)
def test_compile_extras_match_jax(name, drives):
    """The port's own compile of the mesh gives the JAX package's extras, live rows only."""
    jp, tp, (_ts, jtopo, _params) = drives
    prefix = f"energy:{name}/"
    want = {k: v for k, v in jtopo.extras.items() if k.startswith(prefix)}
    got = {k: v for k, v in tp.topo.extras.items() if k.startswith(prefix)}
    assert sorted(got) == sorted(want) and want
    live = want[prefix + "valid"]
    assert bool(live.all()) and live.numel() > 1, f"{name}: an empty table"
    for key in want:
        w, g = want[key], got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.is_floating_point():
            assert_close(g, w, 1e-15, key, atol_scale=1.0)
        else:
            assert torch.equal(g, w), key


def _frozen_energy_and_grads(name, spec, ts, topo, params):
    pre, fn = tget_module(name).make_tilt_frozen(spec)
    fr = pre(ts, topo, params)
    tin = ts.tilts_in.clone().requires_grad_(True)
    tout = ts.tilts_out.clone().requires_grad_(True)
    e = fn(tin, tout, fr, topo, params)
    return e, torch.autograd.grad(e, (tin, tout), allow_unused=True)


def _full_energy_and_grads(name, spec, ts, topo, params):
    E, g = _port_value_and_grads(_energy_fn(tget_module, name, spec), ts, topo, params)
    return E, g[1:]


SMOOTH = ["tilt_smoothness_in", "tilt_smoothness_out", "tilt_smoothness_leaflet"]
TRANSPORTS = ["ambient_v1", "connection_v1"]


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("name", SMOOTH)
def test_frozen_split_matches_full_energy(name, transport):
    """precompute + per-iteration energy equals the full module energy and its tilt gradients."""
    jp, tp, (ts, topo, params) = _pair({"tilt_transport_model": transport})
    E, g = _full_energy_and_grads(name, tp.spec, ts, topo, params)
    e, gf = _frozen_energy_and_grads(name, tp.spec, ts, topo, params)
    assert float(e.detach()) == pytest.approx(E, rel=RTOL)
    for got, want in zip(gf, g):
        got = np.zeros_like(want) if got is None else to_np(got)
        assert_close(got, want, RTOL, f"{name} frozen", atol_scale=1e-300)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_unified_smoothness_is_in_plus_out(transport, drives):
    _jp, tp, (ts, topo, params) = drives
    spec = dataclasses.replace(tp.spec, static_options=tp.spec.static_options
                               + (("tilt_transport_model", transport),))
    E, g = _full_energy_and_grads("tilt_smoothness_leaflet", spec, ts, topo, params)
    parts = [_full_energy_and_grads(n, spec, ts, topo, params)
             for n in ("tilt_smoothness_in", "tilt_smoothness_out")]
    assert E == pytest.approx(parts[0][0] + parts[1][0], rel=RTOL)
    assert_close(g[0], parts[0][1][0], RTOL, "d/dtilts_in")
    assert_close(g[1], parts[1][1][1], RTOL, "d/dtilts_out")


# (module, extra global parameters): the transports, the twist term, the
# recovered divergence
MODES = {
    "smoothness_in_connection": ("tilt_smoothness_in", {"tilt_transport_model": "connection_v1"}),
    "smoothness_out_connection": ("tilt_smoothness_out",
                                  {"tilt_transport_model": "connection_v1"}),
    "leaflet_connection": ("tilt_smoothness_leaflet", {"tilt_transport_model": "connection_v1"}),
    "splay_twist_connection": ("tilt_splay_twist_in",
                               {"tilt_transport_model": "connection_v1",
                                "tilt_twist_modulus_in": 0.45}),
    "splay_twist_twist": ("tilt_splay_twist_in", {"tilt_twist_modulus": 0.45}),
    "splay_vertex_recovered": ("tilt_splay_twist_in",
                               {"tilt_divergence_mode": "vertex_recovered",
                                "tilt_twist_modulus_in": 0.45}),
    "smoothness_out_absent_disk": ("tilt_smoothness_out",
                                   {"leaflet_out_absent_presets": ["disk"]}),
    "leaflet_absent_disk_connection": ("tilt_smoothness_leaflet",
                                       {"leaflet_out_absent_presets": ["disk"],
                                        "tilt_transport_model": "connection_v1"}),
    "splay_vertex_recovered_in_connection": ("tilt_splay_twist_in",
                                             {"tilt_divergence_mode_in": "vertex_recovered",
                                              "tilt_divergence_mode": "native",
                                              "tilt_transport_model": "connection_v1"}),
}


@pytest.mark.parametrize("case", list(MODES))
def test_modes_match_jax(case):
    name, gp = MODES[case]
    jp, tp, port_inputs = _pair(gp)
    assert dict(tp.spec.static_options).items() >= {
        k: str(v) for k, v in gp.items() if isinstance(v, str)}.items()
    _assert_module_matches(name, jp, tp, port_inputs, f" [{case}]")


@pytest.mark.parametrize("leaflet", ["in", "out"])
def test_consistent_tilt_mass_matches_jax(leaflet):
    jp, tp, port_inputs = _pair({f"tilt_mass_mode_{leaflet}": "consistent"})
    gj = _assert_module_matches(f"tilt_{leaflet}", jp, tp, port_inputs, " consistent")
    # the consistent mass is another energy than the lumped one
    lumped, ltp, lports = _pair()
    Ej, _g = _jax_value_and_grads(_energy_fn(jget_module, f"tilt_{leaflet}", lumped.spec), lumped)
    Ec, _g = _jax_value_and_grads(_energy_fn(jget_module, f"tilt_{leaflet}", jp.spec), jp)
    assert abs(Ec - Ej) > 1e-6 * abs(Ej)
    assert max(float(np.max(np.abs(g))) for g in gj) > 0.0


# ----------------------------------------------------------------------
# float32: the fold into the fused frozen-tilt energy
# ----------------------------------------------------------------------
SMOOTH_LANE = ["tilt_smoothness_in", "tilt_smoothness_out"]
# (extra global parameters, extra modules, the smoothness modules folded)
FOLDS = {
    "both_ambient": ({}, SMOOTH_LANE, SMOOTH_LANE),
    "in_only": ({}, ["tilt_smoothness_in"], ["tilt_smoothness_in"]),
    "connection_not_folded": ({"tilt_transport_model": "connection_v1"}, SMOOTH_LANE, []),
    # the outer leaflet absent on the disk: the fold keeps the module's mask
    "out_absent_disk": ({"leaflet_out_absent_presets": ["disk"]}, SMOOTH_LANE, SMOOTH_LANE),
}


def _lane_problem(gp, modules):
    """kozlov SMALL with the bench parameters and ``modules`` added, both packages, seeded state."""
    from membrane_solver_tpu import Minimizer as JMinimizer
    from membrane_solver_tpu import parse_geometry as jparse
    from membrane_solver_tpu.meshgen import build as jbuild
    from membrane_solver_tpu_torch import Minimizer as TMinimizer
    from membrane_solver_tpu_torch import parse_geometry as tparse
    from membrane_solver_tpu_torch.meshgen import build as tbuild

    meshes = [parse(build("kozlov_1disk", **SMALL)) for parse, build in
              ((jparse, jbuild), (tparse, tbuild))]
    for mesh in meshes:
        mesh.global_parameters.update({**BENCH_GP, **gp})
        mesh.energy_modules.extend(modules)
    jp = JMinimizer(meshes[0], quiet=True).problem()
    tspec = TMinimizer(meshes[1], device="cpu", dtype=torch.float32, quiet=True).problem().spec
    return jp, tspec


def _jax_fused(jp, js):
    state = dataclasses.replace(js, **{f: getattr(js, f).astype(jnp.float32)
                                       for f in ("positions", "tilts", "tilts_in", "tilts_out")})
    params = {k: jnp.asarray(v, jnp.float32) for k, v in jp.params.items()}
    e_pre, e_fns, _c_pre, _c_fns, e_names = jrelax.collect_frozen_tilt_program(jp.spec)
    e_frozen = [p(state, jp.topo, params) for p in e_pre]
    fused_fn, rest = jrelax._build_fused_tilt_energy(jp.spec, e_names, e_fns, e_frozen, state,
                                                     jp.topo, params, jnp.float32)
    rows = jp.topo.tri_rows

    def energy(tin, tout):
        return fused_fn(tin[rows], tout[rows])

    tin, tout = state.tilts_in, state.tilts_out
    e, grads = jax.value_and_grad(energy, argnums=(0, 1))(tin, tout)
    return float(e), [np.asarray(g)[: jp.n_vertices] for g in grads], len(rest)


@pytest.mark.parametrize("case", list(FOLDS))
def test_fused_energy_with_smoothness_matches_jax_pallas_interpret(case, monkeypatch):
    monkeypatch.setenv("MEMBRANE_SOLVER_PALLAS", "1")
    gp, modules, folded = FOLDS[case]
    jp, tspec = _lane_problem(gp, modules)
    js, ts = perturbed_pair(jp, seed=53, dtype=torch.float32)
    want_e, want_g, j_rest = _jax_fused(jp, js)
    _s, topo, params = port_from_jax(jp, dtype=torch.float32)
    e_pre, e_fns, _c_pre, _c_fns, e_names = trelax.collect_frozen_tilt_program(tspec)
    e_frozen = [p(ts, topo, params) for p in e_pre]
    fused, rest = trelax.build_fused_tilt_energy(tspec, e_names, e_fns, e_frozen, topo, params,
                                                 torch.float32)
    assert len(rest) == j_rest and not set(folded) & set(fused.rest_names)
    assert set(modules) - set(folded) <= set(fused.rest_names)
    for k, leaflet in ((4, "in"), (5, "out")):
        on = f"tilt_smoothness_{leaflet}" in folded
        assert (float(fused.k_vec[k]) > 0.0) == on, leaflet
        w = fused.payload[:, 14:17] if leaflet == "in" else fused.payload[:, 17:20]
        assert bool(torch.any(w != 0.0)) == on, leaflet
    tin = ts.tilts_in.clone().requires_grad_(True)
    tout = ts.tilts_out.clone().requires_grad_(True)
    e = fused(tin, tout)
    got_g = torch.autograd.grad(e, (tin, tout))
    assert float(e.detach()) == pytest.approx(want_e, rel=ENERGY_RTOL)
    for got, want in zip(got_g, want_g):
        assert_close(got, want, GRAD_RTOL, case)


def test_consistent_mass_runs_per_module():
    """The fused path refuses the consistent tilt mass, as the JAX package's does."""
    jp, tspec = _lane_problem({"tilt_mass_mode": "consistent"}, SMOOTH_LANE)
    _s, topo, params = port_from_jax(jp, dtype=torch.float32)
    js, ts = perturbed_pair(jp, seed=5, dtype=torch.float32)
    e_pre, e_fns, _c_pre, _c_fns, e_names = trelax.collect_frozen_tilt_program(tspec)
    e_frozen = [p(ts, topo, params) for p in e_pre]
    assert trelax.build_fused_tilt_energy(tspec, e_names, e_fns, e_frozen, topo, params,
                                          torch.float32) is None
