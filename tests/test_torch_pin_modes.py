"""The pin constraints' slide and fit group modes against the JAX package (float64, kozlov L0).

On meshgen ``kozlov_1disk`` (177 vertices) with seeded heights and tilts
(``_torch_port_harness.seeded_pair``), each constraint compiled by the port
itself (its own tables) and evaluated on the same state as the JAX
package's:

- ``pin_to_plane`` in ``fixed``, ``slide`` (and its ``normal_only``
  alias) and ``fit`` (the global mode: the disk and the rim ring form one
  group with the disk's normal, or none under fit);
- ``pin_to_circle`` with the rim and outer rings in ``slide`` and ``fit``
  (their radius fitted; under fit the rim ring's normal too), once with the
  rim group preserving its normal offset in the mesh-operation contexts.

Held at rel 1e-12: the compiled tables, the enforcement (in the
``minimize`` context, and in ``mesh_operation`` and ``finalize`` for a
normal-preserving circle group and a plane group, the contexts differing
only for preserving groups), the dense KKT rows and the local normals; the
group planes and circles themselves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port_harness import BENCH_GP, assert_close, seeded_pair, to_np

REL = 1e-12
FREE = {"pin_to_circle_radius": None}
# config -> (global parameters, preset -> definition options)
CONFIGS = {
    "plane_fixed": ({}, {}),
    "plane_slide": ({"pin_to_plane_mode": "slide"}, {}),
    "plane_normal_only": ({"pin_to_plane_mode": "normal_only"}, {}),
    "plane_fit": ({"pin_to_plane_mode": "fit"}, {}),
    "plane_disk_slide": ({}, {"disk": {"pin_to_plane_mode": "slide"}}),
    "circle_slide": ({}, {"rim": {"pin_to_circle_mode": "slide", **FREE},
                          "outer_rim": {"pin_to_circle_mode": "slide", **FREE}}),
    "circle_fit": ({}, {"rim": {"pin_to_circle_mode": "fit", "pin_to_circle_normal": None, **FREE},
                        "outer_rim": {"pin_to_circle_mode": "fit", **FREE}}),
    "circle_fit_given_radius": ({}, {"rim": {"pin_to_circle_mode": "fit"}}),
    "circle_slide_preserve": ({"pin_to_circle_mesh_operation_preserve_normal_groups": ["rim"]},
                              {"rim": {"pin_to_circle_mode": "slide", **FREE}}),
}
CONSTRAINT = {name: "pin_to_plane" if name.startswith("plane") else "pin_to_circle"
              for name in CONFIGS}
_CACHE: dict = {}


def _mesh(pkg, name):
    from chip_smoke import lane_edits

    from membrane_solver_tpu.meshgen import build

    gp, defs = CONFIGS[name]
    m = pkg.parse_geometry(build("kozlov_1disk"))
    m.global_parameters.update({**BENCH_GP, **gp})
    lane_edits(m, {"definition_options": defs})
    return m


def case(name: str):
    """(JAX problem, JAX state, port problem, port state) on one seeded state."""
    if name in _CACHE:
        return _CACHE[name]
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg

    jp = jpkg.Minimizer(_mesh(jpkg, name), quiet=True).problem()
    tp = tpkg.Minimizer(_mesh(tpkg, name), quiet=True, device="cpu").problem()
    js, ts = seeded_pair(jp, 4)
    _CACHE[name] = (jp, js, tp, ts)
    return _CACHE[name]


def _modules(name):
    from membrane_solver_tpu.constraints import get_constraint as jget
    from membrane_solver_tpu_torch.constraints import get_constraint as tget

    return jget(CONSTRAINT[name]), tget(CONSTRAINT[name])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tables_match_jax(name):
    """Rows, modes, groups and group tables; the fixed-only tables carry no group keys."""
    jp, _js, tp, _ts = case(name)
    key = f"constraint:{CONSTRAINT[name]}"
    jx = {k.rsplit("/", 1)[1]: np.asarray(v) for k, v in jp.topo.extras.items()
          if k.startswith(key + "/")}
    tx = {k.rsplit("/", 1)[1]: to_np(v) for k, v in tp.topo.extras.items()
          if k.startswith(key + "/")}
    grouped = name not in ("plane_fixed",)
    if CONSTRAINT[name] == "pin_to_plane":
        n = int(jx["valid"].sum())
        for k in ("rows", "valid", "normal", "point", "vertex_fixed"):
            np.testing.assert_array_equal(tx[k], jx[k][:n], err_msg=k)
        group_keys = ("mode", "group", "group_mode", "group_normal", "group_has_normal")
        if not grouped:
            assert not set(group_keys) & set(tx)
            return
        for k in group_keys:
            want = jx[k] if k.startswith("group_") else jx[k][:n]
            np.testing.assert_array_equal(tx[k], want, err_msg=k)
        return
    nf, nm = int(jx["f_valid"].sum()), int(jx["m_valid"].sum())
    for k in [k for k in jx if k.startswith("f_")]:
        np.testing.assert_array_equal(tx[k], jx[k][:max(nf, 1)], err_msg=k)
    assert nm > 0
    for k in [k for k in jx if k.startswith("m_")]:
        np.testing.assert_array_equal(tx[k], jx[k][:nm], err_msg=k)
    for k in [k for k in jx if k.startswith("g_")]:
        np.testing.assert_array_equal(tx[k], jx[k], err_msg=k)


# the contexts differ only for groups that preserve their normal offset
ENFORCE_CASES = [(name, "minimize") for name in CONFIGS] + [
    (name, context) for name in ("circle_slide_preserve", "plane_slide")
    for context in ("mesh_operation", "finalize")]


@pytest.mark.parametrize("name,context", ENFORCE_CASES)
def test_enforce_matches_jax(name, context):
    jp, js, tp, ts = case(name)
    jmod, tmod = _modules(name)
    nv = jp.n_vertices
    want = np.asarray(jmod.enforce(js, jp.topo, jp.params, context=context).positions)[:nv]
    got = tmod.enforce(ts, tp.topo, tp.params, context=context).positions
    assert_close(got, want, REL, "positions", atol_scale=1.0)
    moved = np.max(np.abs(want - np.asarray(js.positions)[:nv]))
    assert moved > 1e-6, "the seeded state is off the constraint"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rows_and_normals_match_jax(name):
    jp, js, tp, ts = case(name)
    jmod, tmod = _modules(name)
    nv = jp.n_vertices
    want = np.asarray(jmod.constraint_gradient_rows(js, jp.topo, jp.params))[:, :nv]
    got = to_np(tmod.constraint_gradient_rows(ts, tp.topo, tp.params))
    live = np.abs(want).reshape(want.shape[0], -1).max(axis=1) > 0
    got_live = np.abs(got).reshape(got.shape[0], -1).max(axis=1) > 0
    assert_close(got[got_live], want[live], REL, "rows", atol_scale=1.0)
    want_n = np.asarray(jmod.local_constraint_normals(js, jp.topo, jp.params))[:nv]
    got_n = tmod.local_constraint_normals(ts, tp.topo, tp.params)
    assert_close(got_n, want_n, REL, "local normals", atol_scale=1.0)


@pytest.mark.parametrize("name", [n for n in CONFIGS if n != "plane_fixed"])
def test_group_fits_match_jax(name):
    """The group planes (normal, centroid) and circles (normal, center, radius)."""
    jp, js, tp, ts = case(name)
    jmod, tmod = _modules(name)
    if CONSTRAINT[name] == "pin_to_plane":
        want = jmod._group_planes(js.positions, jp.topo)
        got = tmod._group_planes(ts.positions, tp.topo)
    else:
        want = jmod._group_circles(js.positions, jp.topo)
        got = tmod._group_circles(ts.positions, tp.topo)[:3]
    for w, g, what in zip(want, got, ("normal", "center", "radius")):
        assert_close(g, w, REL, what, atol_scale=1.0)
    if name == "plane_fit":
        assert abs(float(got[0][0, 2])) < 1.0 - 1e-6, "the fitted normal leaves z"


def test_group_modes_leave_fixed_vertices():
    """Under slide the fixed disk center keeps its place; under fixed it is projected."""
    for name, moves in (("plane_fixed", True), ("plane_slide", False)):
        jp, js, tp, ts = case(name)
        _jmod, tmod = _modules(name)
        table = tp.topo.extras
        center = int(table["constraint:pin_to_plane/rows"][
            table["constraint:pin_to_plane/vertex_fixed"]][0])
        lifted = ts.positions.clone()
        lifted[center, 2] = 0.125
        st = dataclasses.replace(ts, positions=lifted)
        out = tmod.enforce(st, tp.topo, tp.params)
        assert (float(out.positions[center, 2]) != 0.125) == moves
        assert torch.isfinite(out.positions).all()
