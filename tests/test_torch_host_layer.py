"""The port's host layer (a NumPy copy) against the JAX package's.

Mesh generators, the input parser, refinement and expressions: the port
copies them, so every array must be identical, not merely close.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from _torch_port_harness import BENCH_GP, make_minimizer

import membrane_solver_tpu as jpkg
import membrane_solver_tpu_torch as tpkg
from membrane_solver_tpu.meshgen import BUILDERS as JAX_BUILDERS
from membrane_solver_tpu.meshgen import build as jbuild
from membrane_solver_tpu_torch.meshgen import BUILDERS as PORT_BUILDERS
from membrane_solver_tpu_torch.meshgen import build as tbuild


def _mesh_arrays(mesh):
    mesh.build_connectivity_maps()
    tri, fids = mesh.triangle_rows()
    edges = np.array(
        [(e, mesh.edges[e].tail_index, mesh.edges[e].head_index) for e in sorted(mesh.edges)]
    )
    return {
        "vertex_ids": np.asarray(mesh.vertex_ids),
        "positions": mesh.positions_array(),
        "tilts_in": mesh.tilts_in_array(),
        "tilts_out": mesh.tilts_out_array(),
        "fixed": mesh.fixed_mask(),
        "tri_rows": np.asarray(tri),
        "tri_facets": np.asarray(fids),
        "edges": edges,
    }


def _assert_same_mesh(jm, tm):
    ja, ta = _mesh_arrays(jm), _mesh_arrays(tm)
    for key in ja:
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
    assert tm.energy_modules == jm.energy_modules
    assert tm.constraint_modules == jm.constraint_modules
    assert tm.global_parameters.to_dict() == jm.global_parameters.to_dict()


def test_builder_registry_matches():
    assert sorted(PORT_BUILDERS) == sorted(JAX_BUILDERS)


@pytest.mark.parametrize("name", sorted(JAX_BUILDERS))
def test_builder_output_and_parse_identical(name):
    data_j, data_t = jbuild(name), tbuild(name)
    assert json.dumps(data_t, sort_keys=True) == json.dumps(data_j, sort_keys=True)
    _assert_same_mesh(jpkg.parse_geometry(data_j), tpkg.parse_geometry(data_t))


def test_kozlov_refinement_ladder_counts():
    """L0-L2 identical arrays; L3 the lane's 10,817 vertices and 21,504 triangles."""
    from membrane_solver_tpu.runtime import refinement as jref
    from membrane_solver_tpu_torch.runtime import refinement as tref

    jm = jpkg.parse_geometry(jbuild("kozlov_1disk"))
    tm = tpkg.parse_geometry(tbuild("kozlov_1disk"))
    counts = []
    for level in range(4):
        if level:
            jm = jref.refine_triangle_mesh(jref.refine_polygonal_facets(jm))
            tm = tref.refine_triangle_mesh(tref.refine_polygonal_facets(tm))
        sizes_j = (len(jm.vertices), len(jm.edges), len(jm.facets))
        assert (len(tm.vertices), len(tm.edges), len(tm.facets)) == sizes_j
        if level < 3:
            _assert_same_mesh(jm, tm)
        counts.append(sizes_j)
    assert counts[3][0] == 10_817 and counts[3][2] == 21_504


def test_refined_protocol_mesh_identical():
    """Refinement inside the Minimizer protocol (enforce after mesh ops)."""
    jm = make_minimizer(False, kw={"n_sectors": 8, "n_outer_rings": 4, "n_disk_rings": 2},
                        refines=1)
    tm = make_minimizer(True, kw={"n_sectors": 8, "n_outer_rings": 4, "n_disk_rings": 2},
                        refines=1)
    ja, ta = _mesh_arrays(jm.mesh), _mesh_arrays(tm.mesh)
    for key in ("vertex_ids", "tri_rows", "tri_facets", "edges", "fixed"):
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
    np.testing.assert_allclose(ta["positions"], ja["positions"], rtol=0, atol=1e-13)


def test_bench_gp_round_trip_through_save_geometry(tmp_path):
    mesh = tpkg.parse_geometry(tbuild("kozlov_1disk", n_sectors=8, n_outer_rings=4,
                                      n_disk_rings=2))
    mesh.global_parameters.update(BENCH_GP)
    path = tmp_path / "lane.json"
    tpkg.save_geometry(mesh, str(path))
    again = tpkg.parse_geometry(tpkg.load_data(str(path)))
    _assert_same_mesh(mesh, again)


@pytest.mark.parametrize(
    "expr",
    ["sin(x) * y + 2", "sqrt(x**2 + y**2)", "exp(-x) - log(y + 3)", "abs(x - y) / (1 + y**2)"],
)
def test_compiled_expression_matches_jax(expr):
    from membrane_solver_tpu.core.expr import compile_expr as jcompile
    from membrane_solver_tpu_torch.core.expr import compile_expr as tcompile

    rng = np.random.default_rng(3)
    x, y = rng.uniform(0.1, 2.0, 17), rng.uniform(0.1, 2.0, 17)
    want = np.asarray(jcompile(expr, ("x", "y"))(x, y))
    got = tcompile(expr, ("x", "y"))(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
