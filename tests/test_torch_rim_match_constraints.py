"""The rim tilt-matching constraints in the port against the JAX package, float64.

On meshgen ``kozlov_1disk`` at L0: ``tilt_leaflet_match_rim`` on the
``rim_slope_match_group`` rim ring (16 vertices) and ``tilt_vector_match_rim``
with that ring as role disk and the outer ring (16) as role rim, plus a
group of three disk and two rim vertices, which neither package pairs
(unequal counts).  At a seeded perturbed state, one ring vertex's inner
tilt fixed: the dense tilt rows and the enforced leaflet tilts in every
mode and alias, to 1e-12 of the largest entry.
"""

from __future__ import annotations

import pytest
import torch
from _torch_port_harness import _pkg, assert_close, make_minimizer, module_fn, seeded_pair, to_np

REL = 1e-12


def problems(gp: dict):
    """(JAX problem, port problem) with both constraints, the ring tags and ``gp``."""
    out = []
    for port in (False, True):
        mn = make_minimizer(port, **({"dtype": torch.float64} if port else {}))
        mesh = mn.mesh
        mesh.constraint_modules.extend(["tilt_leaflet_match_rim", "tilt_vector_match_rim"])
        mesh.global_parameters.update({"tilt_leaflet_match_group": "rim", **gp})
        odd = {"disk": 3, "rim": 2}
        first_fixed = True
        for vid in sorted(mesh.vertices):
            opts = mesh.vertices[vid].options
            ring = opts.get("rim_slope_match_group")
            if ring == "rim":
                opts.update(tilt_leaflet_match_group="rim", tilt_vector_match_group="ring",
                            tilt_vector_match_role="disk")
                if first_fixed:
                    mesh.vertices[vid].tilt_fixed_in = True
                    first_fixed = False
            elif ring == "outer":
                opts.update(tilt_vector_match_group="ring", tilt_vector_match_role="rim")
            elif opts.get("preset") == "outer_rim":
                role = "disk" if odd["disk"] else "rim" if odd["rim"] else None
                if role:
                    odd[role] -= 1
                    opts.update(tilt_vector_match_group="odd", tilt_vector_match_role=role)
        pkg = _pkg(port)[0]
        kw = {"device": "cpu", "dtype": torch.float64} if port else {}
        out.append(pkg.Minimizer(mesh, quiet=True, **kw).problem())
    return out


def compare(gp: dict, name: str):
    jp, tp = problems(gp)
    jst, tst = seeded_pair(jp, seed=9)
    nv = jp.n_vertices
    got, want = [], []
    for p, st, port, out in ((jp, jst, False, want), (tp, tst, True, got)):
        mod = module_fn(p, "constraint", name, port)
        out.append(to_np(mod.make_tilt_constraint_rows(p.spec)(st, p.topo, p.params))[:, :, :nv])
        res = mod.make_enforce_tilts(p.spec)(st, p.topo, p.params)
        out.extend(to_np(getattr(res, f))[:nv] - to_np(getattr(st, f))[:nv]
                   for f in ("tilts_in", "tilts_out"))
    for what, a, b in zip(("rows", "tilts_in change", "tilts_out change"), got, want,
                          strict=True):
        assert_close(a, b, REL, f"{name} {gp} {what}", atol_scale=1e-300)
    return jp, tp, got


@pytest.mark.parametrize("mode", ["average", "in_to_out", "out_to_in", "bogus"])
def test_tilt_leaflet_match_rim_matches_jax(mode):
    jp, tp, (rows, d_in, d_out) = compare({"tilt_leaflet_match_mode": mode},
                                          "tilt_leaflet_match_rim")
    assert tp.spec.static_of("constraint:tilt_leaflet_match_rim") == (
        jp.spec.static_of("constraint:tilt_leaflet_match_rim"))
    assert rows.shape[0] == 2 and abs(rows[:, 0] + rows[:, 1]).max() == 0.0
    assert abs(d_out).max() > 0.0 or mode == "out_to_in"


@pytest.mark.parametrize("mode", ["average", "rim_to_disk", "rim2disk", "disk_to_rim",
                                  "disk2rim"])
def test_tilt_vector_match_rim_matches_jax(mode):
    jp, tp, (rows, d_in, d_out) = compare({"tilt_vector_match_mode": mode},
                                          "tilt_vector_match_rim")
    static = tp.spec.static_of("constraint:tilt_vector_match_rim")
    assert static == tuple(jp.spec.static_of("constraint:tilt_vector_match_rim"))
    assert static[1] == 1  # the "odd" group (3 disk, 2 rim) is skipped
    assert rows.shape[0] == 4
    assert abs(d_in).max() > 0.0 and abs(d_out).max() > 0.0


def test_unequal_group_alone_gives_no_rows():
    """Without the paired rings, the odd group alone: no rows and no change, as in JAX."""
    out = []
    for port in (False, True):
        mn = make_minimizer(port, **({"dtype": torch.float64} if port else {}))
        mesh = mn.mesh
        mesh.constraint_modules.append("tilt_vector_match_rim")
        for role, vids in (("disk", (1, 2, 3)), ("rim", (4, 5))):
            for vid in vids:
                mesh.vertices[vid].options.update(tilt_vector_match_group="odd",
                                                  tilt_vector_match_role=role)
        pkg = _pkg(port)[0]
        kw = {"device": "cpu", "dtype": torch.float64} if port else {}
        p = pkg.Minimizer(mesh, quiet=True, **kw).problem()
        mod = module_fn(p, "constraint", "tilt_vector_match_rim", port)
        out.append((p.spec.static_of("constraint:tilt_vector_match_rim"),
                    mod.make_tilt_constraint_rows(p.spec)(p.state, p.topo, p.params),
                    mod.make_enforce_tilts(p.spec)(p.state, p.topo, p.params) is p.state))
    assert tuple(out[0][0]) == out[1][0] == ("average", 0)
    assert out[0][1] is None and out[1][1] is None
    assert out[0][2] and out[1][2]
