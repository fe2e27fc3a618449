"""The port's scaffold-trace lane pieces against the JAX package (float64, kozlov L0).

On meshgen ``kozlov_1disk`` with the physical-edge rim placement and the
scaffold-trace switches (``tests/test_torch_physical_edge.py``'s
``scaffold`` flavour plus ``theory_parity_lane``, the trace-reconstructed
outer divergence, the ``trace_boundary_v1`` inner stencil and the
``trace_z`` fallback), with ``chip_smoke.lane_tags``' tags (the trace
shell's 16 rows ``pin_to_circle_group: trace_layer``, the next three
shells' 48 rows ``outer_shell_scaffold_index``):

- the trace-layer and shared-rim row weights of ``tilt_in``/``tilt_out``
  (the latter with ``tests/test_gp_option_parity.py``'s tagging) and the
  outer leaflet's restored presence masks, as compiled;
- the five tilt energies with both gradients (positions, leaflet tilts) on
  a seeded state, their frozen splits and the frozen tilt gradients, all at
  rel 1e-12; the recovered divergence alone; the kernel gate;
- the lane protocols of ``tests/fixtures/torch_port/kozlov_L3_{physical_edge,
  scaffold}_f64_jax.json`` at L0 through ``minimize(2)``, step for step.
"""

from __future__ import annotations

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_port_harness import (
    BENCH_GP,
    assert_close,
    energy_and_grads,
    make_minimizer,
    port_from_jax,
    seeded_pair,
    to_np,
)

from membrane_solver_tpu.energy import bending_tilt_leaflet as jbt
from membrane_solver_tpu.runtime import tilt_relax as jrelax
from membrane_solver_tpu_torch.energy import bending_tilt_leaflet as tbt
from membrane_solver_tpu_torch.runtime import tilt_relax as trelax

REL = 1e-12
FIXTURES = Path(__file__).parent / "fixtures" / "torch_port"
SCAFFOLD_GP = {
    "rim_slope_match_mode": "physical_edge_staggered_v1",
    "parity_trace_layer_radius": 1.364262,
    "parity_outer_shells": 3,
    "theory_parity_lane": "kozlov",
    "bending_tilt_interface_divergence_mode": "trace_reconstructed_v1",
    "bending_tilt_in_scaffold_shape_stencil_mode": "trace_boundary_v1",
    "shape_scaffold_rejected_step_fallback": "trace_z",
}
TAGS = {"scaffold_tags": {"trace_radius": 1.364262, "support_shells": 3}}
TILT_MODULES = ("tilt_in", "tilt_out", "bending_tilt_in", "bending_tilt_out",
                "tilt_thetaB_contact_in")
_CACHE: dict = {}


def scaffold_case():
    """(JAX problem, port problem namespace, JAX state, port state) on a seeded state."""
    if "case" in _CACHE:
        return _CACHE["case"]
    gp = {**BENCH_GP, **SCAFFOLD_GP}
    jp = make_minimizer(False, gp=gp, edits=TAGS).problem()
    tspec = make_minimizer(True, gp=gp, edits=TAGS, dtype=torch.float64).problem().spec
    js, ts = seeded_pair(jp, 9)
    _s, topo, params = port_from_jax(jp)
    tp = types.SimpleNamespace(spec=tspec, topo=topo, params=params, n_vertices=jp.n_vertices)
    _CACHE["case"] = (jp, tp, js, ts)
    return _CACHE["case"]


def _port_problem(gp: dict, edits=None):
    return make_minimizer(True, gp={**BENCH_GP, **gp}, edits=edits,
                          dtype=torch.float64).problem()


def _jax_problem(gp: dict, edits=None):
    return make_minimizer(False, gp={**BENCH_GP, **gp}, edits=edits).problem()


def test_compiled_scaffold_extras_match_jax():
    """Row weights, scaffold masks, the stencil's trace mask and the trace_z mask."""
    jp, tp, _js, _ts = scaffold_case()
    port = _port_problem(SCAFFOLD_GP, TAGS)
    keys = ("energy:tilt_in/row_weights", "energy:tilt_out/row_weights",
            "energy:bending_tilt_out/scaffold_trace", "energy:bending_tilt_out/scaffold_support",
            "energy:bending_tilt_out/scaffold_release", "energy:bending_tilt_in/stencil_trace",
            "core:scaffold_trace/mask")
    nv = jp.n_vertices
    for key in keys:
        want = np.asarray(jp.topo.extras[key])[:nv]
        np.testing.assert_array_equal(to_np(port.topo.extras[key]), want.astype(float), key)
    w = to_np(port.topo.extras["energy:tilt_in/row_weights"])
    trace = to_np(port.topo.extras["core:scaffold_trace/mask"]).astype(bool)
    assert trace.sum() == 16 and np.all(w[trace] < 1.0) and np.all(w[~trace] == 1.0)
    assert to_np(port.topo.extras["energy:bending_tilt_out/scaffold_support"]).sum() == 48


@pytest.mark.parametrize("leaflet,gp", [
    ("out", {"tilt_out_exclude_shared_rim_outer_rows": True}),
    ("in", {"tilt_in_exclude_shared_rim_rows": True,
            "tilt_in_shared_rim_outer_row_energy_weight": 0.25}),
    ("in", {**SCAFFOLD_GP, "tilt_in_shared_rim_outer_row_energy_weight": 0.25}),
], ids=["out_exclude", "in_exclude_scale", "in_scale_times_trace"])
def test_shared_rim_row_weights_match_jax(leaflet, gp):
    """test_gp_option_parity's tagging: four rim and four outer rows tagged, the rest untagged."""
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu.meshgen import build

    data = build("kozlov_1disk")
    rim, outer = [], []
    for v in data["vertices"]:
        opts = v[-1] if isinstance(v[-1], dict) else None
        if opts is None:
            continue
        if opts.get("preset") == "rim" and len(rim) < 4:
            opts["rim_slope_match_group"] = "rim"
            rim.append(v)
        elif opts.get("preset") == "outer" and len(outer) < 4:
            opts["rim_slope_match_group"] = "outer"
            outer.append(v)
    assert rim and outer
    got = []
    for pkg, kw in ((jpkg, {}), (tpkg, {"device": "cpu"})):
        mesh = pkg.parse_geometry(json.loads(json.dumps(data)))
        mesh.global_parameters.update(gp)
        p = pkg.Minimizer(mesh, quiet=True, **kw).problem()
        w = p.topo.extras.get(f"energy:tilt_{leaflet}/row_weights")
        got.append(None if w is None else to_np(w)[: p.n_vertices])
    assert got[1] is not None
    np.testing.assert_array_equal(got[1], got[0])
    assert np.any(got[1] != 1.0)


def test_restored_presence_masks_match_jax():
    """The outer leaflet's disk absence with the shells kept present (triangle absence mode)."""
    gp = {"rim_slope_match_mode": "physical_edge_staggered_v1",
          "leaflet_out_absent_presets": ["disk"], "leaflet_out_absence_mode": "triangles"}
    jp, port = _jax_problem(gp), _port_problem(gp)
    nv, nf = jp.n_vertices, jp.n_tris
    for key, n in (("absent_out", nv), ("tri_present_out", nf)):
        want = np.asarray(jp.topo.extras[f"energy:leaflet_presence/{key}"])[:n]
        np.testing.assert_array_equal(to_np(port.topo.extras[f"energy:leaflet_presence/{key}"]),
                                      want.astype(float), key)
    # at L0 the whole disk group is the shells' disk ring: every disk row stays
    assert to_np(port.topo.extras["energy:leaflet_presence/absent_out"]).sum() == 0
    plain = _port_problem({k: v for k, v in gp.items() if k != "rim_slope_match_mode"})
    assert to_np(plain.topo.extras["energy:leaflet_presence/absent_out"]).sum() == 33


@pytest.mark.parametrize("name", TILT_MODULES)
def test_energies_and_gradients_match_jax(name):
    """Weighted tilt energies, recovered and reconstructed divergence, the stencil."""
    jp, tp, js, ts = scaffold_case()
    je, jg = energy_and_grads(jp, name, js, False)
    te, tg = energy_and_grads(tp, name, ts, True)
    assert abs(te - je) <= REL * abs(je), f"{name}: {te} vs {je}"
    for g_t, g_j, field in zip(tg, jg, ("positions", "tilts", "tilts_in", "tilts_out")):
        assert_close(g_t, g_j, REL, f"{name} d/d{field}", atol_scale=1e-300)
    if name == "bending_tilt_in":
        # trace_boundary_v1: no z shape gradient on the trace rows
        trace = to_np(tp.topo.extras["energy:bending_tilt_in/stencil_trace"]).astype(bool)
        assert np.all(tg[0][trace, 2] == 0.0) and np.any(tg[0][~trace, 2] != 0.0)


def test_frozen_split_matches_jax():
    """The frozen tilt energies (recovery weights baked) and their tilt gradients."""
    jp, tp, js, ts = scaffold_case()
    import jax

    jprog = jrelax.collect_frozen_tilt_program(jp.spec)
    tprog = trelax.collect_frozen_tilt_program(tp.spec)
    assert list(jprog[4]) == list(tprog[4])
    nv = jp.n_vertices
    for jpre, jfn, tpre, tfn, name in zip(jprog[0], jprog[1], tprog[0], tprog[1], tprog[4]):
        jf = jpre(js, jp.topo, jp.params)
        tf = tpre(ts, tp.topo, tp.params)
        assert ("smooth_w" in jf) == ("smooth_w" in tf) == (name == "bending_tilt_in")
        je, jgr = jax.value_and_grad(lambda a, b: jfn(a, b, jf, jp.topo, jp.params),
                                     argnums=(0, 1))(js.tilts_in, js.tilts_out)
        tin = ts.tilts_in.clone().requires_grad_(True)
        tout = ts.tilts_out.clone().requires_grad_(True)
        te = tfn(tin, tout, tf, tp.topo, tp.params)
        tgr = (torch.autograd.grad(te, (tin, tout), allow_unused=True) if te.requires_grad
               else (None, None))
        assert abs(float(te.detach()) - float(je)) <= REL * abs(float(je)), name
        for g_t, g_j in zip(tgr, jgr):
            want = np.asarray(g_j)[:nv]
            assert_close(np.zeros_like(want) if g_t is None else g_t, want, REL, name,
                         atol_scale=1e-300)


def test_recovered_divergence_matches_jax():
    jp, tp, js, ts = scaffold_case()
    rng = np.random.default_rng(4)
    nf = jp.n_tris
    div = np.zeros(np.asarray(jp.topo.tri_valid).shape[0])
    div[:nf] = rng.standard_normal(nf)
    import jax.numpy as jnp

    want = np.asarray(jbt.recovered_divergence(jnp.asarray(div), js.positions, jp.topo))[:nf]
    got = tbt.recovered_divergence(torch.as_tensor(div[:nf]), ts.positions, tp.topo)
    assert_close(got, want, REL, "recovered divergence")


@pytest.mark.parametrize("gp,fused", [
    ({"rim_slope_match_mode": "physical_edge_staggered_v1"}, True),
    ({"theory_parity_lane": "kozlov"}, False),
    ({"bending_tilt_interface_divergence_mode": "trace_reconstructed_v1"}, False),
], ids=["physical_edge", "recovered", "reconstructed"])
def test_frozen_tilt_kernel_gate(gp, fused):
    """At float32 the fused frozen-tilt energy is built where the JAX package builds its kernel's."""
    mn = make_minimizer(True, gp={**BENCH_GP, **gp}, dtype=torch.float32)
    p = mn.problem()
    e_pre, e_fns, _c_pre, _c_fns, e_names = trelax.collect_frozen_tilt_program(p.spec)
    frozen = [pre(p.state, p.topo, p.params) for pre in e_pre]
    built = trelax.build_fused_tilt_energy(p.spec, e_names, e_fns, frozen, p.topo, p.params,
                                           torch.float32)
    assert (built is not None) == fused


def test_mode_errors_match_jax():
    """The interface-divergence and stencil modes' ValueError texts, raised where JAX raises them."""
    for key, text in (("bending_tilt_interface_divergence_mode", "p1_triangle"),
                      ("bending_tilt_in_scaffold_shape_stencil_mode", "trace_boundary_v1")):
        texts = []
        for port in (False, True):
            mn = make_minimizer(port, gp={**BENCH_GP, key: "bogus"})
            with pytest.raises(ValueError) as err:
                mn.compute_energy()
            texts.append(str(err.value))
        assert texts[0] == texts[1] and text in texts[1]


# ---------------------------------------------------------------- lanes at L0
def lane_protocol(name: str) -> dict:
    return json.loads((FIXTURES / f"kozlov_L3_{name}_f64_jax.json").read_text())["protocol"]


NOISE = json.loads((FIXTURES / "physical_edge_L0_noise.json").read_text())


def _lane_run(port: bool, protocol: dict, steps: int):
    mn = make_minimizer(port, gp=protocol["global_parameters"], edits=protocol,
                        **({"dtype": torch.float64} if port else {}))
    return [mn.minimize(1) for _ in range(steps)]


@pytest.fixture(scope="module", params=["physical_edge", "scaffold"])
def lane(request):
    """(name, JAX steps, port steps) at L0, two ``minimize(1)`` each."""
    protocol = lane_protocol(request.param)
    steps = NOISE["steps"]
    return request.param, _lane_run(False, protocol, steps), _lane_run(True, protocol, steps)


def test_lane_minimize_matches_jax(lane):
    """Per step the accept flag and the energy.

    The energy within round-off, or within twice the JAX package's own
    spread under 1e-15 of z noise (ROADMAP C3; ``physical_edge_L0_noise.json``,
    recorded by ``tools/record_torch_port_fixture.py``) where that is
    larger: at L0 the lanes' singular KKT systems (three conditions per
    shell row) amplify round-off to ~1e-3 in one step, in both packages.
    The trace_z fallback does not fire at L0 (every step is accepted); at
    L3 ``chip_smoke.py`` phases 26-29 hold its decisions.
    """
    name, jax_steps, port_steps = lane
    rec = NOISE["lanes"][name]
    for k, (jr, tr) in enumerate(zip(jax_steps, port_steps)):
        want = float(jr["energy"])
        assert tr["step_success"] == bool(jr["step_success"]), f"step {k}: accept flag"
        assert tr["trace_z_fallbacks"] == 0
        bound = max(1e-10, 2.0 * rec["rel_spread"][k])
        assert abs(tr["energy"] - want) <= bound * abs(want), f"step {k}: {tr['energy']} vs {want}"
