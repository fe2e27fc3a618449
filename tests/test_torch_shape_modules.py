"""The shape family's modules in the port against the NumPy reference and the JAX package.

On the CPU at float64:

- energies (``line_tension``, ``jordan_area``, ``edge_length_penalty``,
  ``expression``, ``body_area_penalty``): energy and shape gradient
  against the NumPy reference's fixtures
  (``tests/fixtures/module_parity2/refmod2_{flat,cube_body}_*.npz``, on
  ``tools/record_module_parity.flat_lane_dict()`` and ``cube_body_dict()``),
  to rel 1e-12, and against the JAX package live on the same lane, to rel
  1e-12.  The reference differentiates ``expression`` by finite differences
  (the JAX package's exact gradient is 4.2e-11 of max|g| from that
  fixture), so there the fixture's gradient bound is 1e-10 of max|g| and
  the 1e-12 bar is the live JAX one;
- constraints (``global_area``, ``body_area``, ``perimeter``,
  ``fix_facet_area``, ``fixed_plane``, ``expression``): the enforced
  positions and the KKT constraint rows against the JAX package live, on
  the fan disks of ``tests/test_constraint_modules_unit.py`` (and the cube
  for the body area), to 1e-12 of the positions' scale;
- the area and area gradient of ``global_area`` and ``body_area``, which
  the port takes from the surface whole call
  (``kernels/tri_kernels.surface_energy_and_gradient``), against the JAX
  modules' own functions on a perturbed cube, to 1e-12;
- the registries: the reference's empty placeholders load as no-ops; the
  last twelve modules to be ported load and expose the hooks their JAX
  modules have; every file of the JAX package's ``energy`` and
  ``constraints`` packages has a counterpart that loads.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_port_harness  # noqa: F401  (its torch thread count for the xdist workers)
from membrane_solver_tpu_torch.device import geo as tgeo

RTOL = 1e-12
FD_RTOL = 1e-10  # the reference's finite-difference gradient of ``expression``
FIXTURES = _torch_port_harness.FIXTURE.parent.parent / "module_parity2"


def _port_problem(data: dict, energies=(), constraints=(), gp=None):
    import membrane_solver_tpu_torch as tpkg

    mesh = tpkg.parse_geometry(json.loads(json.dumps(data)))
    mesh.global_parameters.update(gp or {})
    for name in energies:
        if name not in mesh.energy_modules:
            mesh.energy_modules.append(name)
    for name in constraints:
        if name not in mesh.constraint_modules:
            mesh.constraint_modules.append(name)
    return tpkg.Minimizer(mesh, device="cpu", dtype=torch.float64, quiet=True).problem()


def _module_fn(name, spec):
    from membrane_solver_tpu_torch.energy import get_module

    mod = get_module(name)
    maker = getattr(mod, "make_energy", None)
    return maker(spec) if maker is not None else mod.energy


def _value_and_grad(p, name):
    fn = _module_fn(name, p.spec)
    x = p.state.positions.clone().requires_grad_(True)
    st = dataclasses.replace(p.state, positions=x)
    E = fn(tgeo.triangle_geometry(x, p.topo.tri_rows, p.topo.tri_valid), st, p.topo, p.params)
    (g,) = torch.autograd.grad(E, (x,))
    return float(E.detach()), g.numpy()


# ----------------------------------------------------------------------
# energies against the NumPy reference's fixtures
# ----------------------------------------------------------------------
FLAT_MODULES = ["line_tension", "jordan_area", "edge_length_penalty", "expression"]


@pytest.fixture(scope="module")
def flat_problem():
    from tools.record_module_parity import flat_lane_dict

    return _port_problem(flat_lane_dict(), energies=FLAT_MODULES)


@pytest.fixture(scope="module")
def cube_body_problem():
    from tools.record_module_parity import cube_body_dict

    return _port_problem(cube_body_dict(), energies=["body_area_penalty"])


def _check_reference(p, lane, name):
    fx = np.load(FIXTURES / f"refmod2_{lane}_{name}.npz")
    vids = np.load(FIXTURES / f"refmod2_{lane}_vids.npy")
    row = {int(v): i for i, v in enumerate(p.vertex_ids)}
    perm = np.array([row[int(v)] for v in vids])
    E, g = _value_and_grad(p, name)
    want_E = float(fx["E"])
    assert abs(E - want_E) <= RTOL * abs(want_E), f"{name}: E={E!r} vs {want_E!r}"
    err = np.abs(g[perm] - fx["grad"]).max()
    rtol = FD_RTOL if name == "expression" else RTOL
    assert err <= rtol * np.abs(fx["grad"]).max(), f"{name}: gradient error {err:.3e}"


@pytest.mark.parametrize("name", FLAT_MODULES)
def test_flat_energy_matches_the_reference(flat_problem, name):
    _check_reference(flat_problem, "flat", name)


def test_body_area_penalty_matches_the_reference(cube_body_problem):
    _check_reference(cube_body_problem, "cube_body", "body_area_penalty")


@pytest.mark.parametrize("name", FLAT_MODULES)
def test_flat_energy_matches_jax(flat_problem, name):
    import jax

    import membrane_solver_tpu as jpkg
    from membrane_solver_tpu.device import geo as jgeo
    from membrane_solver_tpu.energy import get_module as jget_module
    from tools.record_module_parity import flat_lane_dict

    mesh = jpkg.parse_geometry(json.loads(json.dumps(flat_lane_dict())))
    mesh.energy_modules.extend(n for n in FLAT_MODULES if n not in mesh.energy_modules)
    jp = jpkg.Minimizer(mesh, quiet=True).problem()
    mod = jget_module(name)
    fn = mod.make_energy(jp.spec) if hasattr(mod, "make_energy") else mod.energy

    def f(x):
        geo = jgeo.triangle_geometry(x, jp.topo.tri_rows, jp.topo.tri_valid)
        return fn(geo, dataclasses.replace(jp.state, positions=x), jp.topo, jp.params)

    want_E, want_g = jax.value_and_grad(f)(jp.state.positions)
    E, g = _value_and_grad(flat_problem, name)
    assert E == pytest.approx(float(want_E), rel=RTOL)
    want_g = np.asarray(want_g)[: flat_problem.n_vertices]
    assert np.abs(g - want_g).max() <= RTOL * np.abs(want_g).max()


# ----------------------------------------------------------------------
# constraints against the JAX package live
# ----------------------------------------------------------------------
def _fan_disk(pkg_name: str, n_ring=8, radius=1.0, z_noise=None):
    """The fan disk of test_constraint_modules_unit: center 1, ring 2..n_ring+1."""
    import importlib

    ent = importlib.import_module(f"{pkg_name}.geometry.entities")
    Mesh = importlib.import_module(f"{pkg_name}.geometry.mesh").Mesh
    mesh = Mesh()
    mesh.vertices[1] = ent.Vertex(1, np.array([0.0, 0.0, 0.0]))
    rng = np.random.default_rng(7)
    for i in range(n_ring):
        ang = 2 * np.pi * i / n_ring
        z = float(z_noise * rng.standard_normal()) if z_noise else 0.0
        mesh.vertices[2 + i] = ent.Vertex(2 + i, np.array([radius * np.cos(ang),
                                                           radius * np.sin(ang), z]))
    for i in range(n_ring):
        mesh.edges[1 + i] = ent.Edge(1 + i, 1, 2 + i)
    for i in range(n_ring):
        mesh.edges[1 + n_ring + i] = ent.Edge(1 + n_ring + i, 2 + i, 2 + (i + 1) % n_ring)
    for i in range(n_ring):
        mesh.facets[1 + i] = ent.Facet(1 + i, [1 + i, 1 + n_ring + i, -(1 + (i + 1) % n_ring)])
    return mesh


def _cube_mesh(pkg_name: str, body_opts=None):
    import importlib

    pkg = importlib.import_module(pkg_name)
    build = importlib.import_module(f"{pkg_name}.meshgen").build
    data = build("cube")
    data.pop("instructions", None)
    faces = data["bodies"]["faces"][0]
    data["bodies"] = {"0": {"faces": faces, "target_volume": 1.0, **(body_opts or {})}}
    mesh = pkg.parse_geometry(data)
    rng = np.random.default_rng(11)
    for vid in sorted(mesh.vertices):
        mesh.vertices[vid].position[:] += 0.05 * rng.standard_normal(3)
    return mesh


def _set_up(mesh, constraints, gp, fixed=(), vertex_opts=None, facet_opts=None, edge_opts=None):
    mesh.global_parameters.update(gp or {})
    for vid in fixed:
        mesh.vertices[vid].fixed = True
    for table, opts in ((mesh.vertices, vertex_opts), (mesh.facets, facet_opts),
                        (mesh.edges, edge_opts)):
        for key, o in (opts or {}).items():
            table[key].options.update(o)
    for c in constraints:
        if c not in mesh.constraint_modules:
            mesh.constraint_modules.append(c)
    if "surface" not in mesh.energy_modules:
        mesh.energy_modules.append("surface")
    return mesh


# (id, mesh maker, constraints, global parameters, fixed vertices, vertex /
# facet / edge options)
CASES = [
    ("global_area", "fan", ["global_area"], {"target_surface_area": 2.5}, (), None, None, None),
    ("global_area_fixed", "fan", ["global_area"], {"target_surface_area": 2.5}, (1,), None, None,
     None),
    ("perimeter", "fan", ["perimeter"],
     {"perimeter_constraints": [{"edges": list(range(9, 17)), "target_perimeter": 5.0}]}, (3,),
     None, None, None),
    ("fixed_plane", "fan_noisy", ["fixed_plane"], None, (3,), None, None, None),
    ("fixed_plane_custom", "fan_noisy", ["fixed_plane"],
     {"fixed_plane_normal": [0.0, 0.0, 2.0], "fixed_plane_point": [0, 0, 0.5]}, (), None, None,
     None),
    ("fix_facet_area", "fan_noisy", ["fix_facet_area"], None, (4,), None,
     {1: {"target_area": 0.45}, 2: {"target_area": 0.2}, 5: {"target_area": 0.3}}, None),
    ("expression", "fan_noisy", ["expression"], None, (),
     {2: {"constraint_expression": "x*x + y*y", "constraint_target": 1.44},
      5: {"constraint_expression": "z + 0.5*x", "constraint_target": 0.1}},
     {3: {"constraint_expression": "z", "constraint_target": 0.05}},
     {10: {"constraint_expression": "x + y", "constraint_target": 0.9}}),
    ("body_area", "cube", ["body_area"], None, (2,), None, None, None),
]


def _pair(case):
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg

    _cid, kind, constraints, gp, fixed, vopts, fopts, eopts = case
    out = []
    for pkg, name, kw in ((jpkg, "membrane_solver_tpu", {}),
                          (tpkg, "membrane_solver_tpu_torch", {"device": "cpu"})):
        if kind == "cube":
            mesh = _cube_mesh(name, {"target_area": 5.5})
        else:
            mesh = _fan_disk(name, z_noise=0.3 if kind == "fan_noisy" else None)
        _set_up(mesh, constraints, gp, fixed, vopts, fopts, eopts)
        out.append(pkg.Minimizer(mesh, quiet=True, **kw).problem())
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_constraint_matches_jax(case):
    from membrane_solver_tpu.runtime import jit_core as jcore
    from membrane_solver_tpu_torch.runtime import jit_core as tcore

    jp, tp = _pair(case)
    nv = tp.n_vertices
    np.testing.assert_array_equal(np.asarray(jp.state.positions)[:nv], tp.state.positions.numpy())
    for context in ("mesh_operation", "minimize"):
        want = np.asarray(jcore.make_constraint_enforcer(jp.spec)(
            jp.state, jp.topo, jp.params, context=context).positions)[:nv]
        got = tcore.make_constraint_enforcer(tp.spec)(
            tp.state, tp.topo, tp.params, context=context).positions.numpy()
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got - want).max() <= RTOL * scale, context
        assert np.abs(got - tp.state.positions.numpy()).max() > 1e-6  # the projection moved
    jrows = jcore.make_constraint_gradients(jp.spec)(jp.state, jp.topo, jp.params)
    trows = tcore.make_constraint_gradients(tp.spec)(tp.state, tp.topo, tp.params)
    if jrows is None:
        assert trows is None
    else:
        want = np.asarray(jrows)[:, :nv]
        assert trows.shape == want.shape and np.abs(want).max() > 0
        assert np.abs(trows.numpy() - want).max() <= RTOL * max(np.abs(want).max(), 1.0)


def test_area_constraints_take_the_surface_call_and_match_jax():
    from membrane_solver_tpu.constraints import body_area as jbody
    from membrane_solver_tpu.constraints import global_area as jglobal
    from membrane_solver_tpu_torch.constraints import body_area as tbody
    from membrane_solver_tpu_torch.constraints import global_area as tglobal
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    case = ("body_area", "cube", ["body_area", "global_area"], {"target_surface_area": 6.2}, (),
            None, None, None)
    jp, tp = _pair(case)
    nv = tp.n_vertices
    before = tk.LAUNCHES["surface_energy_grad"]
    for (area, grad), (want_area, want_grad) in (
            (tglobal._total_area_and_gradient(tp.state.positions, tp.topo),
             jglobal._total_area_and_gradient(jp.state.positions, jp.topo)),
            (tbody._area_and_gradient(tp.state.positions, tp.topo, 0),
             jbody._area_and_gradient(jp.state.positions, jp.topo, 0))):
        assert float(area) == pytest.approx(float(want_area), rel=RTOL)
        want_grad = np.asarray(want_grad)[:nv]
        assert np.abs(grad.numpy() - want_grad).max() <= RTOL * np.abs(want_grad).max()
    # the CPU twin of the whole call: no kernel launch counted
    assert tk.LAUNCHES["surface_energy_grad"] == before


# ----------------------------------------------------------------------
# registries
# ----------------------------------------------------------------------
PLACEHOLDERS = ("edge", "fix_facet_angle", "fix_vertex_position", "dummy_module")


@pytest.mark.parametrize("name", PLACEHOLDERS)
def test_placeholder_constraints_load_as_no_ops(name):
    from membrane_solver_tpu_torch.constraints import get_constraint

    mod = get_constraint(name)
    for hook in ("make_enforce", "compile_topology", "constraint_gradient_rows",
                 "make_tilt_constraint_rows", "enforce_tilts", "local_constraint_normals"):
        assert not hasattr(mod, hook)
    if name == "dummy_module":
        state = object()
        assert mod.enforce(state, None, {}) is state
    else:
        assert not hasattr(mod, "enforce")


def test_placeholders_run_in_a_minimization_as_in_jax():
    """Global area with the four placeholder constraints and the dummy energy, three steps."""
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu_torch.energy import get_module

    energies, positions = [], []
    for pkg, name, kw in ((jpkg, "membrane_solver_tpu", {}),
                          (tpkg, "membrane_solver_tpu_torch", {"device": "cpu"})):
        mesh = _set_up(_fan_disk(name, z_noise=0.3), ["global_area", *PLACEHOLDERS],
                       {"target_surface_area": 2.9})
        mesh.energy_modules.append("dummy_module")
        mn = pkg.Minimizer(mesh, quiet=True, **kw)
        start = mesh.positions_array().copy()
        energies.append([float(mn.minimize(1)["energy"]) for _ in range(3)])
        positions.append(mesh.positions_array())
    assert set(PLACEHOLDERS) <= set(mn.problem().spec.constraint_modules)
    assert get_module("dummy_module").CALLS["count"] > 0
    for got, want in zip(energies[1], energies[0], strict=True):
        assert got == pytest.approx(want, rel=RTOL)
    # the area is held at its target while the steps move the vertices
    assert energies[1][-1] == pytest.approx(2.9, rel=RTOL)
    assert np.abs(positions[1] - start).max() > 1e-3
    assert np.abs(positions[1] - positions[0]).max() <= RTOL


# the hooks (and flags) the runtime reads from an energy or constraint module
HOOKS = ("energy", "make_energy", "make_inloop_energy", "make_tilt_frozen", "compile_topology",
         "compile_static", "enforce", "make_enforce", "make_enforce_tilts",
         "make_frozen_enforce_tilts", "make_tilt_constraint_rows", "make_compact_tilt_rows",
         "constraint_gradient_rows", "make_constraint_gradient_rows",
         "make_compact_constraint_rows", "local_constraint_normals",
         "make_local_constraint_normals", "build_shell_rows", "pack_pairs",
         "compile_topology_pairs", "interface_energy", "USES_TILT", "USES_TILT_LEAFLETS")


@pytest.mark.parametrize("kind,name", [("energy", "bending_tilt"),
                                       ("energy", "mean_curvature_tilt"),
                                       ("constraint", "rigid_disk"),
                                       ("constraint", "local_interface_shells"),
                                       ("energy", "_local_interface"),
                                       ("energy", "curved_local_interface_law"),
                                       ("energy", "curved_local_interface_penalty"),
                                       ("energy", "rim_slope_match_out"),
                                       ("constraint", "curved_local_interface_hard"),
                                       ("constraint", "curved_local_interface_match"),
                                       ("constraint", "tilt_leaflet_match_rim"),
                                       ("constraint", "tilt_vector_match_rim")])
def test_module_loads_as_in_jax(kind, name):
    import importlib

    from membrane_solver_tpu_torch.constraints import get_constraint
    from membrane_solver_tpu_torch.energy import get_module

    sub = "energy" if kind == "energy" else "constraints"
    want = importlib.import_module(f"membrane_solver_tpu.{sub}.{name}")
    got = importlib.import_module(f"membrane_solver_tpu_torch.{sub}.{name}")
    assert [h for h in HOOKS if hasattr(want, h)] == [h for h in HOOKS if hasattr(got, h)]
    for flag in ("USES_TILT", "USES_TILT_LEAFLETS"):
        assert getattr(got, flag, False) == getattr(want, flag, False), flag
    if not name.startswith("_"):
        assert (get_module if kind == "energy" else get_constraint)(name) is got


def test_every_jax_module_file_has_a_loadable_counterpart():
    import importlib
    from pathlib import Path

    import membrane_solver_tpu

    root = Path(membrane_solver_tpu.__file__).parent
    names = []
    for sub in ("energy", "constraints"):
        for path in sorted((root / sub).glob("*.py")):
            if path.stem == "__init__":
                continue
            importlib.import_module(f"membrane_solver_tpu_torch.{sub}.{path.stem}")
            names.append(f"{sub}.{path.stem}")
    assert len(names) == 61, names
