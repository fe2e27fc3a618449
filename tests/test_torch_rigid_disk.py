"""The rigid disk and its closed-form linear algebra in the port against the JAX package, float64.

On the JAX test's fan disk (``tests/test_rigid_and_match_constraints.py``:
a center and a ring of 8 at radius 1, every vertex in ``rigid_disk_group``
d), at a seeded perturbed state: the dense and the compact KKT rows (also
with the center fixed, whose pairs then carry one slot); the enforcement
without a radius (one Kabsch fit) and with ``rigid_disk_radius`` 1 and the
ring as the rim group (the re-pin and the second fit); ``eigh_3x3`` and
``kabsch`` on a planar, a tilted and an improper point set; the first-seen
reference shape kept across ``invalidate()`` and taken anew, as in the JAX
package, after a refinement.  Bar: 1e-12 of the largest entry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port_harness import assert_close, perturbed_pair, to_np

REL = 1e-12


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


def fan_disk(port: bool, n_ring: int = 8, radius: float = 1.0, gp=None, fixed_center=False,
             rim_tag=False, uneven=False):
    """The JAX test's fan disk with every vertex in rigid_disk_group d.

    ``uneven``: ring radii 1, 1.1, 1.2 in turn and heights 0.05 sin(3i), so
    the reference's second moments have no repeated value (see
    :func:`test_enforcement_matches_jax`).
    """
    pkg, Edge, Facet, Vertex, Mesh = _pkg(port)
    mesh = Mesh()
    mesh.vertices[1] = Vertex(1, np.array([0.0, 0.0, 0.0]))
    for i in range(n_ring):
        ang = 2 * np.pi * i / n_ring
        r = radius * (1.0 + 0.1 * (i % 3)) if uneven else radius
        z = 0.05 * np.sin(3.0 * i) if uneven else 0.0
        mesh.vertices[2 + i] = Vertex(2 + i, np.array([r * np.cos(ang), r * np.sin(ang), z]))
    for i in range(n_ring):
        mesh.edges[1 + i] = Edge(1 + i, 1, 2 + i)
        mesh.edges[1 + n_ring + i] = Edge(1 + n_ring + i, 2 + i, 2 + (i + 1) % n_ring)
    for i in range(n_ring):
        mesh.facets[1 + i] = Facet(1 + i, [1 + i, 1 + n_ring + i, -(1 + (i + 1) % n_ring)])
    for vid, v in mesh.vertices.items():
        v.options["rigid_disk_group"] = "d"
        if rim_tag and vid > 1:
            v.options["rim_slope_match_group"] = "rim"
    if fixed_center:
        mesh.vertices[1].fixed = True
    mesh.global_parameters.update({"rigid_disk_group": "d", **(gp or {})})
    mesh.constraint_modules.append("rigid_disk")
    mesh.energy_modules.append("surface")
    return mesh


def minimizers(**kw):
    out = []
    for port in (False, True):
        pkg = _pkg(port)[0]
        extra = {"device": "cpu", "dtype": torch.float64} if port else {}
        out.append(pkg.Minimizer(fan_disk(port, **kw), quiet=True, **extra))
    return out


def _modules():
    from membrane_solver_tpu.constraints import rigid_disk as jrd
    from membrane_solver_tpu_torch.constraints import rigid_disk as trd

    return jrd, trd


@pytest.mark.parametrize("fixed_center", [False, True], ids=["free", "fixed_center"])
def test_kkt_rows_match_jax(fixed_center):
    jrd, trd = _modules()
    jm, tm = minimizers(fixed_center=fixed_center)
    jp, tp = jm.problem(), tm.problem()
    jst, tst = perturbed_pair(jp, seed=2)
    nv = jp.n_vertices
    dense_j = to_np(jrd.make_constraint_gradient_rows(jp.spec)(jst, jp.topo, jp.params))
    dense_t = to_np(trd.make_constraint_gradient_rows(tp.spec)(tst, tp.topo, tp.params))
    k = dense_t.shape[0]
    assert k == 3 * nv - 6
    assert_close(dense_t, dense_j[:k, :nv], REL, "dense rows")
    assert np.abs(dense_j[k:]).max() == 0.0  # the JAX package's capacity padding
    vj, rj = jrd.make_compact_constraint_rows(jp.spec)(jst, jp.topo, jp.params)
    vt, rt = trd.make_compact_constraint_rows(tp.spec)(tst, tp.topo, tp.params)
    assert_close(vt, to_np(vj)[:k], REL, "compact values")
    assert np.array_equal(to_np(rt), to_np(rj)[:k])
    # the compact slots are the dense rows' nonzero entries
    rebuilt = np.zeros_like(dense_t)
    for i in range(k):
        for s in range(2):
            rebuilt[i, int(rt[i, s])] += to_np(vt[i, s])
    assert np.array_equal(rebuilt, dense_t)
    if fixed_center:
        assert np.abs(to_np(vt)[:, 0]).min() == 0.0


@pytest.mark.parametrize("radius", [None, 1.0], ids=["one_fit", "re_pin"])
def test_enforcement_matches_jax(radius):
    """One fit on the fan disk; the re-pin and second fit on the uneven disk.

    The closed-form fit (the JAX package's) loses its digits where the
    cross-covariance has a repeated singular value: on the even fan disk the
    re-pin moves nothing, the second fit's target is an exact rigid copy of
    the symmetric reference, and both packages' rotations then carry errors
    of ~1e-6 from round-off in the repeated pair (each its own).
    """
    jrd, trd = _modules()
    gp = {} if radius is None else {"rigid_disk_radius": radius}
    jm, tm = minimizers(gp=gp, rim_tag=radius is not None, uneven=radius is not None)
    jp, tp = jm.problem(), tm.problem()
    assert tp.spec.static_of("constraint:rigid_disk") == ("has_radius", radius is not None)
    jst, tst = perturbed_pair(jp, seed=4)
    nv = jp.n_vertices
    want = to_np(jrd.make_enforce(jp.spec)(jst, jp.topo, jp.params).positions)[:nv]
    got = to_np(trd.make_enforce(tp.spec)(tst, tp.topo, tp.params).positions)
    assert_close(got, want, REL, "enforced positions")
    # a rigid copy of the reference: the distances to the centroid are the reference's
    ref = to_np(tp.topo.extras["constraint:rigid_disk/ref"])
    d = np.linalg.norm(got - got.mean(axis=0), axis=1)
    assert np.abs(d - np.linalg.norm(ref - ref.mean(axis=0), axis=1)).max() <= 1e-12
    assert np.abs(got - to_np(tst.positions)).max() > 1e-3
    if radius is not None:  # the second fit moved the disk off the first one
        first = trd.make_enforce(dataclasses.replace(tp.spec, extra_static=tuple(
            (k, ("has_radius", False)) if k == "constraint:rigid_disk" else (k, v)
            for k, v in tp.spec.extra_static)))(tst, tp.topo, tp.params)
        assert np.abs(to_np(first.positions) - got).max() > 1e-4


def _point_sets():
    rng = np.random.default_rng(8)
    planar = np.c_[rng.standard_normal((12, 2)), np.zeros(12)]
    tilted = rng.standard_normal((12, 3))
    a, b = 0.7, -0.4
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]) @ \
        np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    return {
        "planar": (planar, planar @ rot.T + [0.3, -0.2, 0.5]),
        "tilted": (tilted, tilted @ rot.T + 1e-3 * rng.standard_normal((12, 3))),
        "improper": (tilted, tilted * np.array([1.0, 1.0, -1.0])),
    }


@pytest.mark.parametrize("case", ["planar", "tilted", "improper"])
def test_eigh_and_kabsch_match_jax(case):
    import jax.numpy as jnp

    from membrane_solver_tpu.device import linalg as jl
    from membrane_solver_tpu_torch.device import linalg as tl

    P, Q = _point_sets()[case]
    Rj, tj = jl.kabsch(jnp.asarray(P), jnp.asarray(Q))
    Rt, tt = tl.kabsch(torch.as_tensor(P), torch.as_tensor(Q))
    assert_close(Rt, Rj, REL, "R")
    assert_close(tt, tj, REL, "t", atol_scale=1.0)
    R = to_np(Rt)
    assert abs(np.linalg.det(R) - 1.0) <= 1e-12
    assert np.abs(R @ R.T - np.eye(3)).max() <= 1e-12
    H = (P - P.mean(0)).T @ (Q - Q.mean(0))
    ej, Vj = jl.eigh_3x3(jnp.asarray(H.T @ H))
    et, Vt = tl.eigh_3x3(torch.as_tensor(H.T @ H))
    assert_close(et, ej, REL, "eigenvalues")
    assert_close(Vt, Vj, REL, "eigenvectors")
    if case == "planar":
        assert abs(float(et[0])) <= 1e-12 * float(et[2])  # rank 2


def test_first_seen_reference_kept_across_invalidate_and_refinement():
    from membrane_solver_tpu.runtime import refinement as jref
    from membrane_solver_tpu_torch.runtime import refinement as tref

    jm, tm = minimizers()
    refs = []
    for mn in (jm, tm):
        ref0 = to_np(mn.problem().topo.extras["constraint:rigid_disk/ref"])
        for v in mn.mesh.vertices.values():  # a rigid shift and a non-rigid offset
            v.position[:] = v.position + np.array([0.1, 0.0, 0.05]) + 0.01 * v.position[::-1]
        mn.invalidate()
        ref1 = to_np(mn.problem().topo.extras["constraint:rigid_disk/ref"])
        assert np.array_equal(ref0, ref1[: len(ref0)])
        refs.append(ref1)
    assert np.array_equal(refs[1], refs[0][: len(refs[1])])
    # a refinement adds disk vertices: the reference is the refined disk as compiled
    out = []
    for mn, ref in ((jm, jref), (tm, tref)):
        mn.mesh = ref.refine_triangle_mesh(mn.mesh)
        mn.invalidate()
        p = mn.problem()
        out.append((to_np(p.topo.extras["constraint:rigid_disk/ref"]), p.n_vertices))
    (rj, nj), (rt, nt) = out
    assert nt == nj and rt.shape[0] == nt
    assert np.array_equal(rt, rj[:nt])
    assert not np.array_equal(rt[: len(refs[1])], refs[1])  # taken anew


def test_dense_rows_agree_with_the_projector_compact_form():
    """The KKT projector takes the compact rows; dense and compact projections agree."""
    from membrane_solver_tpu_torch.runtime import jit_core

    _jm, tm = minimizers(fixed_center=True)
    p = tm.problem()
    grad = torch.as_tensor(np.random.default_rng(6).standard_normal((p.n_vertices, 3)))
    st = dataclasses.replace(p.state, positions=p.state.positions + 0.02 * torch.as_tensor(
        np.random.default_rng(7).standard_normal((p.n_vertices, 3))))
    compact = jit_core.make_gradient_projector(p.spec)(grad, st, p.topo, p.params)
    from membrane_solver_tpu_torch.constraints import rigid_disk

    rows = rigid_disk.make_constraint_gradient_rows(p.spec)(st, p.topo, p.params)
    dense = jit_core.project_gradient_kkt(grad, rows)
    assert_close(compact, dense, 1e-10, "projection")
    assert float(torch.max(torch.abs(torch.einsum("kvc,vc->k", rows, compact)))) <= 1e-10
