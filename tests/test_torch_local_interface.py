"""The curved local-interface family in the port against the JAX package, float64.

On the JAX test's three-ring annulus (``tests/test_local_interface_constraints.py``:
rings of 8 at radii 0.8, 1.0, 1.2, the inner one the disk group) and on
meshgen ``kozlov_1disk`` at L0 (the disk group of 33 vertices): the shell
rows of ``local_interface_shells`` equal to the JAX package's; at a seeded
perturbed state, the energies and gradients of ``curved_local_interface_law``
and ``curved_local_interface_penalty``; the tilt row and the enforcement of
``curved_local_interface_hard``; the tilt rows and the enforcement of
``curved_local_interface_match`` in each of its four modes.  Bar: rel 1e-12
(energies), 1e-12 of the largest entry (arrays).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch
from _torch_port_harness import (
    assert_close,
    energy_and_grads,
    make_minimizer,
    module_fn,
    seeded_pair,
    to_np,
)

REL = 1e-12
GP = {"curved_local_interface_law_strength": 0.8, "curved_local_interface_penalty_strength": 0.7}
ENERGIES = ("curved_local_interface_law", "curved_local_interface_penalty")
MODES = ("vector_average", "local_mixed_match_v1", "rim_to_disk", "disk_to_rim")


def _pkg(port: bool):
    if port:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.geometry.entities import Edge, Facet, Vertex
        from membrane_solver_tpu_torch.geometry.mesh import Mesh
    else:
        import membrane_solver_tpu as pkg
        from membrane_solver_tpu.geometry.entities import Edge, Facet, Vertex
        from membrane_solver_tpu.geometry.mesh import Mesh
    return pkg, Edge, Facet, Vertex, Mesh


def annulus_mesh(port: bool, n=8, radii=(0.8, 1.0, 1.2), zs=(0.0, 0.0, 0.1)):
    """The JAX test's annulus: three rings, triangulated bands, the inner ring the disk group."""
    _p, Edge, Facet, Vertex, Mesh = _pkg(port)
    mesh = Mesh()
    rings, vid = [], 1
    for r, z in zip(radii, zs):
        ring = []
        for i in range(n):
            ang = 2 * np.pi * i / n
            mesh.vertices[vid] = Vertex(vid, np.array([r * np.cos(ang), r * np.sin(ang), z]))
            ring.append(vid)
            vid += 1
        rings.append(ring)
    edge_of, counter = {}, [1]

    def e(u, v):
        if (u, v) in edge_of:
            return edge_of[(u, v)]
        if (v, u) in edge_of:
            return -edge_of[(v, u)]
        mesh.edges[counter[0]] = Edge(counter[0], u, v)
        edge_of[(u, v)] = counter[0]
        counter[0] += 1
        return edge_of[(u, v)]

    fid = 1
    for a_ring, b_ring in zip(rings[:-1], rings[1:]):
        for j in range(n):
            a, a2 = a_ring[j], a_ring[(j + 1) % n]
            b, b2 = b_ring[j], b_ring[(j + 1) % n]
            mesh.facets[fid] = Facet(fid, [e(a, a2), e(a2, b2), e(b2, a)])
            mesh.facets[fid + 1] = Facet(fid + 1, [e(a, b2), e(b2, b), e(b, a)])
            fid += 2
    for v in rings[0]:
        mesh.vertices[v].options["rim_slope_match_group"] = "disk"
    mesh.energy_modules.append("tilt_out")
    mesh.global_parameters.update({"tilt_modulus_out": 1.0})
    return mesh


def kozlov_mesh(port: bool):
    return make_minimizer(port).mesh


MESHES = {"annulus": annulus_mesh, "kozlov_L0": kozlov_mesh}


def problems(mesh_of, mode: str = "vector_average"):
    """(JAX problem, port problem) with the family's modules and ``mode``."""
    out = []
    for port in (False, True):
        mesh = mesh_of(port)
        mesh.energy_modules.extend(ENERGIES)
        mesh.constraint_modules.extend(["curved_local_interface_hard",
                                        "curved_local_interface_match"])
        mesh.global_parameters.update({**GP, "curved_local_interface_match_mode": mode})
        pkg = _pkg(port)[0]
        kw = {"device": "cpu", "dtype": torch.float64} if port else {}
        out.append(pkg.Minimizer(mesh, quiet=True, **kw).problem())
    return out


def _layout(mesh):
    ids = np.asarray(mesh.vertex_ids)
    return types.SimpleNamespace(mesh=mesh, vertex_ids=ids,
                                 row_of={int(v): i for i, v in enumerate(ids)})


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shell_rows_equal_jax(mesh):
    from membrane_solver_tpu.constraints.local_interface_shells import build_shell_rows as jb
    from membrane_solver_tpu_torch.constraints.local_interface_shells import (
        build_shell_rows as tb,
    )

    want = jb(_layout(MESHES[mesh](False)))
    got = tb(_layout(MESHES[mesh](True)))
    assert want is not None and got is not None
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    assert len(want.rim_rows) and len(want.outer_rows)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_law_and_penalty_energies_match_jax(mesh):
    jp, tp = problems(MESHES[mesh])
    jst, tst = seeded_pair(jp, seed=3)
    for name in ENERGIES:
        ej, gj = energy_and_grads(jp, name, jst, port=False)
        et, gt = energy_and_grads(tp, name, tst, port=True)
        assert abs(et - ej) <= REL * abs(ej) and ej > 0.0, name
        for k, (a, b) in enumerate(zip(gt, gj, strict=True)):
            assert_close(a, b, REL, f"{name} grad {k}", atol_scale=1e-300)
    # the law's shape gradient is z-only; the penalty's is zero
    _e, g_law = energy_and_grads(tp, ENERGIES[0], tst, port=True)
    _e, g_pen = energy_and_grads(tp, ENERGIES[1], tst, port=True)
    assert np.abs(g_law[0][:, 2]).max() > 0 and np.abs(g_law[0][:, :2]).max() == 0.0
    assert np.abs(g_pen[0]).max() == 0.0


def _rows_and_enforce(problem, state, name, port):
    mod = module_fn(problem, "constraint", name, port)
    rows = mod.make_tilt_constraint_rows(problem.spec)(state, problem.topo, problem.params)
    out = mod.make_enforce_tilts(problem.spec)(state, problem.topo, problem.params)
    nv = problem.n_vertices
    return to_np(rows)[:, :, :nv], to_np(out.tilts_in)[:nv], to_np(out.tilts_out)[:nv]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_hard_constraint_matches_jax(mesh):
    jp, tp = problems(MESHES[mesh])
    jst, tst = seeded_pair(jp, seed=5)
    want = _rows_and_enforce(jp, jst, "curved_local_interface_hard", False)
    got = _rows_and_enforce(tp, tst, "curved_local_interface_hard", True)
    for what, a, b in zip(("rows", "tilts_in", "tilts_out"), got, want, strict=True):
        assert_close(a, b, REL, what)
    assert got[0].shape[0] == 1 and np.abs(got[0][0, 0]).max() == 0.0
    # the enforced outer tilts meet the ring-averaged condition: a second pass moves nothing
    tst2 = dataclasses.replace(tst, tilts_out=torch.as_tensor(got[2]))
    again = _rows_and_enforce(tp, tst2, "curved_local_interface_hard", True)
    assert np.abs(again[2] - got[2]).max() <= 1e-14


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_match_constraint_matches_jax(mesh, mode):
    jp, tp = problems(MESHES[mesh], mode)
    jst, tst = seeded_pair(jp, seed=7)
    want = _rows_and_enforce(jp, jst, "curved_local_interface_match", False)
    got = _rows_and_enforce(tp, tst, "curved_local_interface_match", True)
    for what, a, b in zip(("rows", "tilts_in", "tilts_out"), got, want, strict=True):
        assert_close(a, b, REL, f"{mode} {what}")
    assert got[0].shape[0] == (2 if mode == "local_mixed_match_v1" else 4)
    assert np.abs(got[1] - to_np(tst.tilts_in)).max() > 0.0
