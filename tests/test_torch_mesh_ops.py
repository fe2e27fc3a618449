"""The port's host mesh operations against the JAX package's, on the CPU.

Equiangulation (``u``), vertex averaging (``V``), the vertex-edge
collision scan and the triangle aspect percentile, on meshgen ``cube``
refined twice and on ``catenoid``, each with the same seeded NumPy
perturbation of its movable vertices in both packages.  The port's copies
must make the same flip decisions (identical facet edge lists and edge
endpoints) and move vertices to within 1e-15.
"""

from __future__ import annotations

import numpy as np
import pytest

import _torch_port_harness  # noqa: F401  (its torch thread count for the xdist workers)

# (builder, triangle refines, perturbation amplitude)
MESHES = {"cube_r2": ("cube", 2, 0.03), "catenoid": ("catenoid", 0, 0.05)}


def _pkgs(port: bool):
    if port:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.meshgen import build
        from membrane_solver_tpu_torch.runtime import (
            equiangulation,
            quality,
            refinement,
            topology_guards,
            vertex_average,
        )
    else:
        import membrane_solver_tpu as pkg
        from membrane_solver_tpu.meshgen import build
        from membrane_solver_tpu.runtime import (
            equiangulation,
            quality,
            refinement,
            topology_guards,
            vertex_average,
        )
    return pkg, build, {"equiangulation": equiangulation, "quality": quality,
                        "refinement": refinement, "topology_guards": topology_guards,
                        "vertex_average": vertex_average}


def make_mesh(port: bool, name: str):
    """The named mesh, refined and perturbed (seeded, movable vertices only)."""
    pkg, build, mods = _pkgs(port)
    builder, refines, amp = MESHES[name]
    mesh = pkg.parse_geometry(build(builder))
    mesh = mods["refinement"].refine_polygonal_facets(mesh)
    for _ in range(refines):
        mesh = mods["refinement"].refine_triangle_mesh(mesh)
    rng = np.random.default_rng(11)
    for vid in sorted(mesh.vertices):
        v = mesh.vertices[vid]
        step = amp * rng.standard_normal(3)
        if not v.fixed:
            v.position = v.position + step
    mesh.increment_version()
    return mesh, mods


def topology(mesh):
    """(facet edge lists, edge endpoints) by id."""
    facets = {int(f): [int(e) for e in mesh.facets[f].edge_indices] for f in mesh.facets}
    edges = {int(e): (int(mesh.edges[e].tail_index), int(mesh.edges[e].head_index))
             for e in mesh.edges}
    return facets, edges


def positions(mesh):
    return np.array([mesh.vertices[v].position for v in sorted(mesh.vertices)])


@pytest.fixture(params=sorted(MESHES))
def pair(request):
    (jm, jmods), (tm, tmods) = make_mesh(False, request.param), make_mesh(True, request.param)
    np.testing.assert_array_equal(positions(tm), positions(jm))
    return jm, jmods, tm, tmods


def test_should_flip_edge_verdicts_match(pair):
    jm, jmods, tm, tmods = pair
    jm.build_connectivity_maps()
    tm.build_connectivity_maps()
    j_verdicts, t_verdicts, flips = {}, {}, 0
    for eid in sorted(jm.edges):
        jf, tf = jm.facets_of_edge(eid), tm.facets_of_edge(eid)
        if len(jf) != 2:
            continue
        j_verdicts[eid] = bool(jmods["equiangulation"].should_flip_edge(jm, jm.edges[eid], *jf))
        t_verdicts[eid] = bool(tmods["equiangulation"].should_flip_edge(tm, tm.edges[eid], *tf))
        flips += j_verdicts[eid]
    assert t_verdicts == j_verdicts
    assert flips > 0, "the perturbation must make some edge non-Delaunay"
    bulk_t = tmods["equiangulation"]._bulk_flip_verdicts(tm)
    assert bulk_t == jmods["equiangulation"]._bulk_flip_verdicts(jm)
    assert {e: v for e, v in bulk_t.items() if e in t_verdicts} == t_verdicts


def test_equiangulate_iteration_matches(pair):
    jm, jmods, tm, tmods = pair
    j_out, j_changed = jmods["equiangulation"].equiangulate_iteration(jm)
    t_out, t_changed = tmods["equiangulation"].equiangulate_iteration(tm)
    assert j_changed and t_changed
    assert topology(t_out) == topology(j_out)
    np.testing.assert_allclose(positions(t_out), positions(j_out), rtol=0, atol=1e-15)


def test_equiangulate_mesh_matches(pair):
    jm, jmods, tm, tmods = pair
    before = topology(tm)
    j_out = jmods["equiangulation"].equiangulate_mesh(jm)
    t_out = tmods["equiangulation"].equiangulate_mesh(tm)
    assert topology(t_out) != before
    assert topology(t_out) == topology(j_out)
    np.testing.assert_allclose(positions(t_out), positions(j_out), rtol=0, atol=1e-15)


@pytest.mark.parametrize("passes", [1, 2])
def test_vertex_average_matches(pair, passes):
    jm, jmods, tm, tmods = pair
    start = positions(tm)
    for _ in range(passes):
        jmods["vertex_average"].vertex_average(jm)
        tmods["vertex_average"].vertex_average(tm)
    assert np.abs(positions(tm) - start).max() > 1e-3
    np.testing.assert_allclose(positions(tm), positions(jm), rtol=0, atol=1e-15)
    fixed = np.array([tm.vertices[v].fixed for v in sorted(tm.vertices)])
    np.testing.assert_array_equal(positions(tm)[fixed], start[fixed])


@pytest.mark.parametrize("threshold", [1e-3, 0.05])
def test_detect_vertex_edge_collisions_matches(pair, threshold):
    jm, jmods, tm, tmods = pair
    got = tmods["topology_guards"].detect_vertex_edge_collisions(tm, threshold)
    want = jmods["topology_guards"].detect_vertex_edge_collisions(jm, threshold)
    assert got == want
    if threshold > 0.01:
        assert got, "a loose threshold must find some vertex near a foreign edge"


@pytest.mark.parametrize("percentile", [50.0, 90.0])
def test_triangle_aspect_percentile_matches(pair, percentile):
    import torch

    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg

    jm, jmods, tm, tmods = pair
    want = jmods["quality"].triangle_aspect_percentile(jpkg.Minimizer(jm, quiet=True), percentile)
    got = tmods["quality"].triangle_aspect_percentile(
        tpkg.Minimizer(tm, quiet=True, device="cpu", dtype=torch.float64), percentile)
    assert np.isfinite(want) and want > 1.0
    assert got == pytest.approx(want, rel=1e-15)
