"""The port's physical-edge rim placement against the JAX package (float64, kozlov L0).

``rim_slope_match_mode`` ``physical_edge_staggered_v1`` on meshgen
``kozlov_1disk`` (177 vertices): the disk group (33 rows, the center
among them) is the matching's rim, each of its rows paired with the
nearest-azimuth row of a 16-row shell, so three conditions share a shell
row.  Four flavours:

- ``edge``: the disk-targeted one (the shell is the pinned rim ring);
- ``trace``: ``parity_trace_layer_radius`` 1.364262 (the shell is the free
  ring at that radius, and the geometric enforcement projects it);
- ``scaffold``: the trace radius with ``parity_outer_shells`` 3 (theta from
  the disk rows' tilts, the inner condition staggered);
- ``scaffold_v2``: the same under the ``continuity_v2`` projector and the
  ``preserve_trace_v1`` mesh-operation mode.

On seeded states (``_torch_port_harness.seeded_pair``), at rel 1e-12 of
each quantity's scale: the compiled flags and rows, the tilt enforcement
(full and frozen; its shared rows run in levels), the trace-shell
projection per context, the dense and compact tilt rows and the shape
rows.  The KKT projections are left out: three conditions on one shell row
make both normal matrices singular (the three out-rows lie in that row's
two-dimensional tangent plane), and the LU solves of the two packages
differ there by far more than round-off; ``test_torch_scaffold_trace.py``
runs the lanes through ``minimize`` against JAX's own noise spread.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port_harness import BENCH_GP, assert_close, port_from_jax, seeded_pair, to_np
from test_torch_rim_modes import _dense_from_compact

from membrane_solver_tpu.constraints import rim_slope_match_out as jrim
from membrane_solver_tpu_torch.constraints import rim_slope_match_out as trim

REL = 1e-12
EDGE = {"rim_slope_match_mode": "physical_edge_staggered_v1"}
TRACE = {**EDGE, "parity_trace_layer_radius": 1.364262}
SCAFFOLD = {**TRACE, "parity_outer_shells": 3, "theory_parity_lane": "kozlov"}
FLAVOURS = {
    "edge": EDGE,
    "trace": TRACE,
    "scaffold": SCAFFOLD,
    "scaffold_v2": {**SCAFFOLD, "rim_slope_match_scaffold_projector_mode": "continuity_v2",
                    "rim_slope_match_scaffold_mesh_operation_mode": "preserve_trace_v1"},
}
_CACHE: dict = {}


def case(flavour: str):
    """(JAX problem, port spec, port (state, topo, params), JAX state) on a seeded state."""
    if flavour in _CACHE:
        return _CACHE[flavour]
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu.meshgen import build

    gp = {**BENCH_GP, **FLAVOURS[flavour]}

    def mesh(pkg):
        m = pkg.parse_geometry(build("kozlov_1disk"))
        m.global_parameters.update(gp)
        return m

    jp = jpkg.Minimizer(mesh(jpkg), quiet=True).problem()
    tspec = tpkg.Minimizer(mesh(tpkg), quiet=True, device="cpu").problem().spec
    js, ts = seeded_pair(jp, 5)
    _s, topo, params = port_from_jax(jp)
    _CACHE[flavour] = (jp, tspec, (ts, topo, params), js)
    return _CACHE[flavour]


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_compile_tables_match_jax(flavour):
    """The flags (shared targets among them), the rim and shell rows and the shell radii."""
    jp, tspec, (_ts, topo, _params), _js = case(flavour)
    flags = tspec.static_of(trim._KEY)
    assert flags == jp.spec.static_of(trim._KEY)
    assert flags[12] is True, "three disk rows share each shell row"
    assert flags[6] == (flavour in ("edge", "trace")), "disk targeting off the scaffold only"
    ex = {k: np.asarray(v) for k, v in jp.topo.extras.items()}
    n = int(ex[f"{trim._KEY}/valid"].sum())
    for key in ("rim", "outer", "disk"):
        np.testing.assert_array_equal(to_np(topo.extras[f"{trim._KEY}/{key}"]),
                                      ex[f"{trim._KEY}/{key}"][:n])
    np.testing.assert_allclose(to_np(topo.extras[f"{trim._KEY}/shell_radii"]),
                               ex[f"{trim._KEY}/shell_radii"], rtol=0, atol=0)
    port_topo = case_port_topo(flavour)
    for key in ("rim", "outer", "disk", "shell_radii"):
        np.testing.assert_array_equal(to_np(port_topo.extras[f"{trim._KEY}/{key}"]),
                                      to_np(topo.extras[f"{trim._KEY}/{key}"]))


def case_port_topo(flavour: str):
    """The port's own compiled topology of the flavour's mesh."""
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu_torch.meshgen import build

    m = tpkg.parse_geometry(build("kozlov_1disk"))
    m.global_parameters.update({**BENCH_GP, **FLAVOURS[flavour]})
    return tpkg.Minimizer(m, quiet=True, device="cpu").problem().topo


@pytest.mark.parametrize("frozen", [False, True], ids=["full", "frozen"])
@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_enforce_tilts_matches_jax(flavour, frozen):
    jp, tspec, (ts, topo, params), js = case(flavour)
    nv = jp.n_vertices
    want = jrim.make_enforce_tilts(jp.spec)(js, jp.topo, jp.params)
    if frozen:
        pre, fn = trim.make_frozen_enforce_tilts(tspec)
        tin, tout = fn(ts.tilts_in, ts.tilts_out, pre(ts, topo, params), topo, params)
    else:
        got = trim.make_enforce_tilts(tspec)(ts, topo, params)
        tin, tout = got.tilts_in, got.tilts_out
    assert_close(tin, np.asarray(want.tilts_in)[:nv], REL, "tilts_in", atol_scale=1.0)
    assert_close(tout, np.asarray(want.tilts_out)[:nv], REL, "tilts_out", atol_scale=1.0)
    # the levels of distinct rows: three per shell row
    assert len(trim._condition_levels(topo, topo.extras[f"{trim._KEY}/outer"])) == 3


@pytest.mark.parametrize("context", ["minimize", "mesh_operation", "finalize"])
@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_trace_projection_matches_jax(flavour, context):
    """make_enforce: None off a trace lane; the moved shell heights and outer tilts on one."""
    jp, tspec, (ts, topo, params), js = case(flavour)
    jfn, tfn = jrim.make_enforce(jp.spec), trim.make_enforce(tspec)
    assert (jfn is None) == (tfn is None) == (flavour == "edge")
    if tfn is None:
        return
    nv = jp.n_vertices
    want = jfn(js, jp.topo, jp.params, context=context)
    got = tfn(ts, topo, params, context=context)
    for f in ("positions", "tilts_in", "tilts_out"):
        assert_close(getattr(got, f), np.asarray(getattr(want, f))[:nv], REL, f, atol_scale=1.0)
    moved = float(np.max(np.abs(to_np(got.positions) - to_np(ts.positions))))
    preserved = flavour == "scaffold_v2" and context != "minimize"
    assert (moved == 0.0) == preserved


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_tilt_rows_match_jax(flavour):
    """Dense and compact tilt rows (the disk-targeted in-rows on the disk row alone)."""
    jp, tspec, (ts, topo, params), js = case(flavour)
    nv = jp.n_vertices
    want = np.asarray(jrim.make_tilt_constraint_rows(jp.spec)(js, jp.topo, jp.params))[:, :, :nv]
    got = to_np(trim.make_tilt_constraint_rows(tspec)(ts, topo, params))
    live = np.abs(want).reshape(want.shape[0], -1).max(axis=1) > 0
    got_live = np.abs(got).reshape(got.shape[0], -1).max(axis=1) > 0
    assert_close(got[got_live], want[live], REL, "dense tilt rows", atol_scale=1.0)
    jc = jrim.make_compact_tilt_rows(jp.spec)(js, jp.topo, jp.params)
    tc = trim.make_compact_tilt_rows(tspec)(ts, topo, params)
    assert len(jc) == len(tc)
    cw = _dense_from_compact(jc, jp.spec.nv_cap)[:, :, :nv]
    cg = _dense_from_compact(tc, nv)
    cw_live = np.abs(cw).reshape(cw.shape[0], -1).max(axis=1) > 0
    cg_live = np.abs(cg).reshape(cg.shape[0], -1).max(axis=1) > 0
    assert_close(cg[cg_live], cw[cw_live], REL, "compact tilt rows", atol_scale=1.0)
    assert_close(cg, got, REL, "compact vs dense tilt rows", atol_scale=1.0)


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_shape_rows_match_jax(flavour):
    jp, tspec, (ts, topo, params), js = case(flavour)
    nv = jp.n_vertices
    want = np.asarray(jrim.make_constraint_gradient_rows(jp.spec)(js, jp.topo, jp.params))[:, :nv]
    got = to_np(trim.make_constraint_gradient_rows(tspec)(ts, topo, params))
    live = np.abs(want).reshape(want.shape[0], -1).max(axis=1) > 0
    got_live = np.abs(got).reshape(got.shape[0], -1).max(axis=1) > 0
    assert_close(got[got_live], want[live], REL, "dense shape rows", atol_scale=1.0)
    fn = trim.make_compact_constraint_rows(tspec)
    assert fn.fixed_rows
    vals, rows = (to_np(x) for x in fn(ts, topo, params))
    compact = np.zeros((vals.shape[0], nv, 3))
    for i in range(vals.shape[0]):
        for a in range(vals.shape[1]):
            compact[i, int(rows[i, a])] += vals[i, a]
    assert_close(compact, got, REL, "compact vs dense shape rows", atol_scale=1.0)


def test_mode_errors_match_jax():
    """The mesh-operation mode's ValueError, where the JAX package raises it."""
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu.meshgen import build

    bad = {**BENCH_GP, **SCAFFOLD, "rim_slope_match_scaffold_mesh_operation_mode": "bogus"}
    texts = []
    for pkg, kw in ((jpkg, {}), (tpkg, {"device": "cpu"})):
        m = pkg.parse_geometry(build("kozlov_1disk"))
        m.global_parameters.update(bad)
        with pytest.raises(ValueError) as err:
            pkg.Minimizer(m, quiet=True, **kw).problem()
        texts.append(str(err.value))
    assert texts[0] == texts[1]
    assert "preserve_trace_v1" in texts[1]


def test_sequential_levels_equal_the_loop():
    """The levels give the one-condition-at-a-time loop's result on the shared rows, bit for bit."""
    jp, tspec, (ts, topo, params), _js = case("scaffold")
    flags = trim._spec_flags(tspec)
    fr = trim._payload(flags, ts.positions, topo)
    theta = trim._theta(flags, ts.tilts_in, fr, params, fr["phi"])
    fields, oks = [ts.tilts_out, ts.tilts_in], [fr["ok_out"], fr["ok_in"]]
    targets = [fr["phi"], theta - fr["phi"]]
    got = trim._staggered_enforce_fields(fields, fr, oks, targets, flags, topo)
    loop = trim._staggered_enforce_fields(
        fields, fr, oks, targets, dataclasses.replace(flags, interp_outer=True), topo)
    for g, w in zip(got, loop):
        assert torch.equal(g, w)


def test_trace_shell_selection_at_L3_matches_jax():
    """``build_shell_rows`` on the kozlov mesh refined three times, in both packages.

    Refinement adds rings of new radii near the disk: without a trace
    radius the first free shell moves inward (0.6948 at L3), while 1.364262
    still selects the 16-row ring of L0, the shell the card lane's fixture
    records.  The host positions come from the port's refinement alone
    (no constraint enforcement), which moves no cylindrical radius here.
    """
    import json
    import types
    from pathlib import Path

    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu.constraints import local_interface_shells as jshells
    from membrane_solver_tpu_torch.constraints import local_interface_shells as tshells
    from membrane_solver_tpu_torch.meshgen import build
    from membrane_solver_tpu_torch.runtime import refinement

    mesh = tpkg.parse_geometry(build("kozlov_1disk"))
    for _ in range(3):
        mesh = refinement.refine_triangle_mesh(refinement.refine_polygonal_facets(mesh))
    vids = np.array(sorted(mesh.vertices))
    layout = types.SimpleNamespace(mesh=mesh, vertex_ids=vids,
                                   row_of={int(v): i for i, v in enumerate(vids)})
    fixture = json.loads((Path(__file__).parent / "fixtures" / "torch_port"
                          / "kozlov_L3_scaffold_f64_jax.json").read_text())["shells"]
    radii = {}
    for trace in (None, 1.364262):
        mesh.global_parameters.update({"parity_trace_layer_radius": trace})
        want, got = jshells.build_shell_rows(layout), tshells.build_shell_rows(layout)
        for field in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, field.name), getattr(want, field.name),
                                          field.name)
        radii[trace] = got.rim_radius
        assert got.disk_rows.size == fixture["conditions"] and got.rim_rows.size == 16
    assert radii[None] < 0.7 < 1.36 < radii[1.364262]
    assert abs(radii[1.364262] - fixture["rim_radius"]) <= 1e-9
