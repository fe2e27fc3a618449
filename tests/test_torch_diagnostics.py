"""The port's diagnostics against the JAX package: Gauss-Bonnet, audit, patches, validators.

Mirrors ``tests/test_diagnostics_and_utils.py`` and ``tests/test_validators.py``
on the port's ``runtime/diagnostics`` and ``runtime/validation``, each case
run in both packages (``pkg``) where it is a statement about one, and
compared where both compute a value:

- the Gauss-Bonnet invariant (G, the interior deficits, the boundary
  loops) of the seeded kozlov L0 host mesh, and the monitor's report after
  a move, at rel 1e-12;
- ``check_gauss_bonnet`` and ``gauss_bonnet_monitor`` through
  ``Minimizer.minimize``, the DEBUG audit helpers and the Lagrange
  tangency check of ``compute_energy_and_gradient``;
- the patch-label boundary edges and lengths;
- ``validate_gaussian_curvature_topology`` (the closed cube, a
  non-manifold edge, a defect mismatch), directly and as ``minimize``
  runs it under ``gaussian_curvature``, with the JAX package's texts.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

PKGS = ["jax", "port"]


def _pkg(name):
    if name == "port":
        import membrane_solver_tpu_torch as pkg
    else:
        import membrane_solver_tpu as pkg
    return pkg


def _mod(name, path):
    import importlib

    root = "membrane_solver_tpu_torch" if name == "port" else "membrane_solver_tpu"
    return importlib.import_module(f"{root}.{path}")


def _kw(name):
    return {"device": "cpu", "dtype": torch.float64} if name == "port" else {}


def _cube(name):
    pkg = _pkg(name)
    mesh = pkg.parse_geometry(pkg.load_data("meshes/cube.json"))
    mesh.instructions = []
    return mesh


def _seeded_kozlov(name):
    from membrane_solver_tpu.meshgen import build

    mesh = _pkg(name).parse_geometry(build("kozlov_1disk"))
    rng = np.random.default_rng(2)
    for vid in sorted(mesh.vertices):
        mesh.vertices[vid].position[2] += 0.03 * rng.standard_normal()
    return mesh


def test_gauss_bonnet_invariant_matches_jax():
    want = _mod("jax", "runtime.diagnostics.gauss_bonnet").gauss_bonnet_invariant(
        _seeded_kozlov("jax"))
    got = _mod("port", "runtime.diagnostics.gauss_bonnet").gauss_bonnet_invariant(
        _seeded_kozlov("port"))
    for g, w in zip(got[:3], want[:3]):
        assert abs(g - w) <= 1e-12 * max(abs(w), 1.0), (g, w)
    assert got[3].keys() == want[3].keys() and len(got[3]) == 1  # the outer rim's loop
    for k, w in want[3].items():
        assert abs(got[3][k] - w) <= 1e-12 * max(abs(w), 1.0)
    assert abs(got[0] - 2.0 * np.pi) <= 1e-9, "a disk: G = 2 pi chi"


@pytest.mark.parametrize("pkg", PKGS)
def test_monitor_reports_drift_after_a_move(pkg):
    gb = _mod(pkg, "runtime.diagnostics.gauss_bonnet")
    mesh = _seeded_kozlov(pkg)
    monitor = gb.GaussBonnetMonitor.from_mesh(mesh, eps_angle=1e-4)
    assert monitor.evaluate(mesh)["ok"]
    loops = gb.extract_boundary_loops(mesh, gb.find_boundary_edges(mesh))
    vid = loops[0][0]
    mesh.vertices[vid].position[:] = np.asarray(mesh.vertices[vid].position) * 1.2 + 0.3
    report = monitor.evaluate(mesh)
    assert not report["ok"] and report["drift_B"][0] > report["tol_B"][0]


def test_monitor_report_matches_jax():
    reports = []
    for pkg in PKGS:
        gb = _mod(pkg, "runtime.diagnostics.gauss_bonnet")
        mesh = _seeded_kozlov(pkg)
        monitor = gb.GaussBonnetMonitor.from_mesh(mesh, eps_angle=1e-5, c1=2.0, c2=0.5)
        vid = sorted(mesh.vertices)[7]
        mesh.vertices[vid].position[2] += 0.2
        reports.append(monitor.evaluate(mesh))
    want, got = reports
    assert got["ok"] == want["ok"]
    for key in ("G", "K_int_total", "B_total", "drift_G", "tol_G"):
        assert abs(got[key] - want[key]) <= 1e-12 * max(abs(want[key]), 1.0), key


@pytest.mark.parametrize("pkg", PKGS)
def test_audit_check_gauss_bonnet_attaches_monitor(pkg):
    audit = _mod(pkg, "runtime.diagnostics.audit")
    mn = _pkg(pkg).Minimizer(_cube(pkg), quiet=True, **_kw(pkg))
    audit.check_gauss_bonnet(mn)
    assert getattr(mn, "_gauss_bonnet_monitor", None) is None  # off by default
    mn.global_params.update({"gauss_bonnet_monitor": True})
    audit.check_gauss_bonnet(mn)
    monitor = mn._gauss_bonnet_monitor
    assert monitor.evaluate(mn.mesh)["ok"]  # no drift without any minimization


def test_minimize_runs_the_monitor(caplog):
    """``gauss_bonnet_monitor`` in ``minimize``: the monitor is built from the synced host mesh."""
    mn = _pkg("port").Minimizer(_cube("port"), quiet=True, **_kw("port"))
    mn.global_params.update({"gauss_bonnet_monitor": True})
    mn.minimize(2)
    first = mn._gauss_bonnet_monitor
    mn.minimize(1)
    assert mn._gauss_bonnet_monitor is first
    assert first.evaluate(mn.mesh)["ok"]


@pytest.mark.parametrize("pkg", PKGS)
def test_audit_logging_helpers_run_at_debug(pkg, caplog):
    audit = _mod(pkg, "runtime.diagnostics.audit")
    mn = _pkg(pkg).Minimizer(_cube(pkg), quiet=True, **_kw(pkg))
    logger = "membrane_solver_tpu_torch" if pkg == "port" else "membrane_solver_tpu"
    with caplog.at_level(logging.DEBUG, logger=logger):
        audit.log_energy_phase(0, "entry", 1.25)
        audit.log_step_direction_stats(0, np.ones((4, 3)))
        audit.log_energy_consistency(mn, "unit")
    text = caplog.text
    assert "E[0:entry]" in text and "grad[0]" in text
    assert "Energy consistency mismatch" not in text
    assert "Energy consistency (unit)" in text


def test_tangency_check_logs_at_debug(caplog):
    """The DEBUG Lagrange tangency line of ``compute_energy_and_gradient``, as the JAX package's."""
    from _torch_port_harness import vesicle_data

    values = []
    for pkg in PKGS:
        logger = "membrane_solver_tpu_torch" if pkg == "port" else "membrane_solver_tpu"
        mesh = _pkg(pkg).parse_geometry(vesicle_data(pkg == "port"))  # a body with a target
        mn = _pkg(pkg).Minimizer(mesh, quiet=True, **_kw(pkg))
        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger=logger):
            mn.compute_energy_and_gradient()
        lines = [r.getMessage() for r in caplog.records if "Lagrange tangency" in r.getMessage()]
        assert len(lines) == 1, lines
        values.append(float(lines[0].rsplit("=", 1)[1]))
        caplog.clear()
        mn.compute_energy_and_gradient()  # off at INFO: no line
        assert not [r for r in caplog.records if "Lagrange tangency" in r.getMessage()]
    # the projected gradient is tangent to the fixed volume: both at round-off
    assert all(abs(v) <= 1e-9 for v in values), values


def _two_patch(pkg):
    import importlib

    test = importlib.import_module("test_diagnostics_and_utils")
    mesh = test._two_patch_disk()
    if pkg == "jax":
        return mesh
    from membrane_solver_tpu_torch.geometry.entities import Edge, Facet, Vertex
    from membrane_solver_tpu_torch.geometry.mesh import Mesh

    out = Mesh()
    for vid, v in mesh.vertices.items():
        out.vertices[vid] = Vertex(vid, np.asarray(v.position, dtype=float))
    for eid, e in mesh.edges.items():
        out.edges[eid] = Edge(eid, e.tail_index, e.head_index)
    for fid, f in mesh.facets.items():
        out.facets[fid] = Facet(fid, list(f.edge_indices))
        out.facets[fid].options.update(f.options)
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_patch_boundaries(pkg):
    patches = _mod(pkg, "runtime.diagnostics.patches")
    mesh = _two_patch(pkg)
    grouped = patches.patch_boundary_edges(mesh)
    assert set(grouped) == {"A", "B"}
    ids_a = sorted(e.index for e in grouped["A"])
    assert ids_a == sorted(e.index for e in grouped["B"]) and len(ids_a) == 2
    lengths = patches.patch_boundary_lengths(mesh)
    assert abs(lengths["A"] - 2.0) < 1e-12 and abs(lengths["B"] - 2.0) < 1e-12
    wide = patches.patch_boundary_edges(_two_patch(pkg), include_mesh_boundary=True)
    assert len(wide["A"]) == 6 and len(wide["B"]) == 6
    only = patches.patch_boundary_edges(_two_patch(pkg), patch_values=["A"])
    assert set(only) == {"A"} and len(only["A"]) == 2


def _non_manifold(pkg):
    ent = _mod(pkg, "geometry.entities")
    mesh = _cube(pkg)
    eid0 = sorted(mesh.edges)[0]
    e0 = mesh.edges[eid0]
    new_vid = max(mesh.vertices) + 1
    mesh.vertices[new_vid] = ent.Vertex(
        new_vid, np.asarray(mesh.vertices[e0.tail_index].position) + [0.3, 0.3, 0.9])
    e1 = max(mesh.edges) + 1
    e2 = e1 + 1
    mesh.edges[e1] = ent.Edge(e1, e0.head_index, new_vid)
    mesh.edges[e2] = ent.Edge(e2, new_vid, e0.tail_index)
    fid = max(mesh.facets) + 1
    mesh.facets[fid] = ent.Facet(fid, [eid0, e1, e2])
    mesh.build_connectivity_maps(force=True)
    return mesh


@pytest.mark.parametrize("case", ["closed_cube", "non_manifold", "defect_mismatch"])
def test_gaussian_topology_validator_matches_jax(case, caplog):
    outcomes = []
    for pkg in PKGS:
        validate = _mod(pkg, "runtime.validation").validate_gaussian_curvature_topology
        mesh = _non_manifold(pkg) if case == "non_manifold" else _cube(pkg)
        gp = mesh.global_parameters
        gp.update({"gaussian_curvature_check_defects": True,
                   "gaussian_curvature_strict_topology": True})
        if case == "defect_mismatch":
            vid = sorted(mesh.vertices)[0]  # moved off: the angle sum no longer closes
            mesh.vertices[vid].position[:] = np.asarray(mesh.vertices[vid].position) * 0.0
            gp.update({"gaussian_curvature_defect_tol": -1.0})
        try:
            validate(mesh, gp)
            outcomes.append(None)
        except ValueError as err:
            outcomes.append(str(err))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (case == "closed_cube")


def test_minimize_validates_gaussian_topology():
    """Under ``gaussian_curvature`` the strict check runs at ``minimize``, once per topology."""
    from membrane_solver_tpu_torch import Minimizer

    mesh = _non_manifold("port")
    mesh.energy_modules.append("gaussian_curvature")
    mesh.global_parameters.update({"gaussian_curvature_strict_topology": True})
    with pytest.raises(ValueError, match="non-manifold"):
        Minimizer(mesh, quiet=True, **_kw("port")).minimize(1)
    cube = _cube("port")
    cube.energy_modules.append("gaussian_curvature")
    cube.global_parameters.update({"gaussian_curvature_strict_topology": True,
                                   "gaussian_curvature_check_defects": True})
    res = Minimizer(cube, quiet=True, **_kw("port")).minimize(1)
    assert np.isfinite(res["energy"])
