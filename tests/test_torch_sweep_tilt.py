"""The parameter sweep over the leaflet tilt-field family (``parallel/sweep``) against JAX's.

Three lanes on the CPU at float64, each with three members:

- ``rect``: meshgen ``rect_tilt_source`` at nx = 20, ny = 8 (189 vertices;
  ``tilt`` + ``tilt_smoothness``) with ``tilt_smoothness_rigidity`` 1.0
  (the lane's kappa; the module reads 0 without it) set before the
  builder's recipe ``g5``, which both packages run through their command
  layers; member m: positions times 1 + 0.001 m, ``tilt_modulus`` and the
  rigidity times 1 + 0.1 m (the tilt-decay scan);
- ``family``: kozlov L0 with ``chip_smoke.drives_setup`` (phase 20's set-up
  and energy list: the ten drives, ``tilt_coupling``, the lane's six),
  then ``chip_smoke.match_drives_setup`` (phase 21's) less its
  local-interface and rigid-disk modules, which the sweep does not batch
  yet (so ``rim_slope_match_out``, ``bending_tilt`` and
  ``mean_curvature_tilt`` with ``tilt_leaflet_match_rim`` and
  ``tilt_vector_match_rim``), then ``seed_host``'s seeded heights and
  leaflet tilts (ROADMAP C3): both module lists in one lane, so JAX
  compiles one vmapped block for them; member m: positions times
  1 + 0.01 m, ``tilt_splay_modulus_in`` and ``rim_slope_match_strength``
  times 1 + 0.1 m.

Against JAX's ``run_sweep`` (its vmapped block on XLA:CPU), two steps at
1e-3: rect under the default options, CG at a fixed step and
``enforce_in_line_search``; family with ``enforce_in_line_search`` (the
tilt enforcer of the two tilt-match constraints in every trial, then the
single-field modules' tangent re-projection) in
``tests/test_torch_sweep_tilt_family.py``, apart because JAX traces and
compiles that lane's vmapped block for about 45 s.  Per member the stats
and the final positions and tilts at rel 1e-10, equal flags and
iterations.

Not against JAX: each of the eighteen modules of the family (sixteen
energies, two tilt-match constraints in each mode) under
``torch.func.vmap`` equal bit for bit to its per-member calls, with the
whole lane's energy, projected gradient and enforcement; the tilts after
a sweep without per-trial enforcement equal the start's bit for bit (the
sweep relaxes no tilts, as JAX's; rect's flat sheet keeps its tangent
planes, so the single-field re-projection changes no bit); with it, every
member that stepped holds the tilt-match conditions (without the
single-field modules, whose re-projection follows the enforcement); with
``bending_tilt`` every accepted state's tilts are tangent to its surface.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.func import vmap

from tests._torch_port_harness import BENCH_GP, recipe_context, seed_host, to_np

REL = 1e-10
SEED = 5
STEPS = 2
STEP_SIZE = 1e-3
RECT = {"nx": 20, "ny": 8}
RECT_GP = {"tilt_smoothness_rigidity": 1.0}
FIXTURES = "tests/fixtures/torch_port/"
STATS = ("energy", "accepted_energy", "grad_norm", "step_size")
FLAGS = ("step_success", "iterations", "converged", "terminated_early", "zero_step_counter")
FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")
# per lane: the scanned parameters (times 1 + 0.1 m) and the dilation step
SCANS = {
    "rect": (("tilt_modulus", "tilt_smoothness_rigidity"), 0.001),
    "family": (("tilt_splay_modulus_in", "rim_slope_match_strength"), 0.01),
}
MATCH_ENERGIES = ("rim_slope_match_out", "bending_tilt", "mean_curvature_tilt")
MATCH_CONSTRAINTS = ("tilt_leaflet_match_rim", "tilt_vector_match_rim")
SINGLE_FIELD = ("bending_tilt", "mean_curvature_tilt")  # their tilt field: ``tilts``
ENFORCE = {"enforce_in_line_search": True}
# (lane, options name, MinimizeOptions arguments): the JAX sweeps of this file
# (the family lane's is ``tests/test_torch_sweep_tilt_family.py``'s)
JAX_CASES = [
    ("rect", "default", {}),
    ("rect", "cg_fixed", {"stepper": "conjugate_gradient", "step_size_mode": "fixed"}),
    ("rect", "enforce", ENFORCE),
]


def _protocol(name: str) -> dict:
    with open(FIXTURES + name) as fh:
        return json.load(fh)["protocol"]


def match_protocol() -> dict:
    """Phase 21's match-drives set-up with only the modules the sweep batches."""
    proto = dict(_protocol("kozlov_L3_match_drives_f64_jax.json"))
    proto["energy_modules"] = list(MATCH_ENERGIES)
    proto["constraint_modules"] = list(MATCH_CONSTRAINTS)
    return proto


def _family(port: bool):
    from chip_smoke import drives_setup, match_drives_setup

    if port:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.meshgen import build

        kw = {"device": "cpu", "dtype": torch.float64}
    else:
        import membrane_solver_tpu as pkg
        from membrane_solver_tpu.meshgen import build

        kw = {}
    mesh = pkg.parse_geometry(build("kozlov_1disk"))
    mesh.global_parameters.update(BENCH_GP)
    drives_setup(mesh, _protocol("kozlov_L3_drives_f64_jax.json"))
    match_drives_setup(mesh, match_protocol())
    mn = pkg.Minimizer(mesh, quiet=True, **kw)
    seed_host(mn, SEED)
    return mn


def _rect(port: bool):
    ctx, run, recipe = recipe_context(port, "rect_tilt_source", gp=RECT_GP, **RECT)
    for cmd in recipe:
        run(ctx, cmd)
    ctx.sync_mesh()
    return ctx.minimizer


def _minimizer(lane: str, port: bool):
    return _rect(port) if lane == "rect" else _family(port)


def members(lane: str, params, positions) -> tuple[list, list]:
    """(member_params, member_positions) of a lane, from either package's problem."""
    keys, dilation = SCANS[lane]
    out = [{k: float(params[k]) * (1.0 + 0.1 * m) for k in keys} for m in range(3)]
    return out, [positions * (1.0 + dilation * m) for m in range(3)]


@pytest.fixture(scope="module")
def port_problems():
    cache = {}

    def get(lane):
        if lane not in cache:
            cache[lane] = _minimizer(lane, True).problem()
        return cache[lane]

    return get


def port_run(problem, lane: str, options: dict, steps: int = STEPS):
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    params, positions = members(lane, problem.params, problem.state.positions.numpy())
    return run_sweep(problem, params, steps, step_size=STEP_SIZE,
                     options=MinimizeOptions(**options), member_positions=positions)


def assert_members_close(got, want, n: int, rel: float) -> None:
    (g_states, _g, g_stats), (w_states, _w, w_stats) = got, want
    for key in STATS:
        g, w = to_np(np.asarray(getattr(g_stats, key))), to_np(np.asarray(getattr(w_stats, key)))
        assert np.all(np.abs(g - w) <= rel * np.abs(w)), f"{key}: {g} vs {w}"
    for key in FLAGS:
        g, w = np.asarray(getattr(g_stats, key)), np.asarray(getattr(w_stats, key))
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), f"{key}: {g} vs {w}"
    for f in FIELDS:
        g, w = to_np(getattr(g_states, f))[:, :n], to_np(getattr(w_states, f))[:, :n]
        for m in range(w.shape[0]):
            scale = max(float(np.max(np.abs(w[m]))), 1.0)
            err = float(np.max(np.abs(g[m] - w[m])))
            assert err <= rel * scale, f"{f} member {m}: {err:.3e} > {rel:.0e} * {scale:.3e}"


@pytest.mark.parametrize("lane,name,options", JAX_CASES, ids=[f"{c[0]}-{c[1]}" for c in JAX_CASES])
def test_sweep_matches_jax_per_member(port_problems, lane, name, options):
    from membrane_solver_tpu.parallel.sweep import run_sweep
    from membrane_solver_tpu.runtime.jit_core import MinimizeOptions

    tp = port_problems(lane)
    jp = _minimizer(lane, False).problem()
    got = port_run(tp, lane, options)
    params, positions = members(lane, jp.params, np.asarray(jp.state.positions))
    want = run_sweep(jp, params, STEPS, step_size=STEP_SIZE, options=MinimizeOptions(**options),
                     member_positions=positions)
    assert_members_close(got, want, tp.n_vertices, REL)
    stats = got[2]
    assert np.asarray(stats.iterations).tolist() == [STEPS] * 3
    assert np.all(np.asarray(stats.grad_norm) > 0.0)
    if lane == "rect":  # the tilt-decay scan takes accepted steps
        assert int(np.sum(np.asarray(stats.accepted_steps))) > 0


def without_single_field(problem):
    """The problem without the single-field modules (no tangent re-projection of the tilts)."""
    return dataclasses.replace(problem, spec=dataclasses.replace(problem.spec, energy_modules=tuple(
        n for n in problem.spec.energy_modules if n not in SINGLE_FIELD)))


@pytest.mark.parametrize("lane", ["rect", "family"])
def test_tilts_stay_without_enforcement(port_problems, lane):
    """No tilt relax and no per-trial enforcement: every member's tilts end as they started
    (on rect, whose flat sheet keeps its tangent planes, with the re-projection on)."""
    tp = port_problems(lane)
    if lane == "family":
        tp = without_single_field(tp)
    states, _ss, stats = port_run(tp, lane, {})
    for f in ("tilts", "tilts_in", "tilts_out"):
        start = getattr(tp.state, f).expand_as(getattr(states, f))
        assert torch.equal(getattr(states, f), start), f
    assert int(np.sum(np.asarray(stats.accepted_steps))) > 0


@pytest.mark.parametrize("name", MATCH_CONSTRAINTS)
def test_tilt_match_rows_hold_per_member(port_problems, name):
    """With per-trial enforcement the members that stepped hold the constraint's conditions.

    One tilt-match constraint at a time (the two share the rim ring, and one
    enforcement pass of each does not make both hold), and no single-field
    module, whose tangent re-projection follows the enforcement.
    """
    from membrane_solver_tpu_torch.constraints import get_constraint
    from membrane_solver_tpu_torch.runtime import tilt_relax as tr

    tp = without_single_field(port_problems("family"))
    spec = dataclasses.replace(tp.spec, constraint_modules=tuple(
        n for n in tp.spec.constraint_modules if n not in MATCH_CONSTRAINTS or n == name))
    assert not tr.spec_uses_vertex_tilts(spec)
    states, _ss, stats = port_run(dataclasses.replace(tp, spec=spec), "family", ENFORCE, steps=3)
    accepted = np.asarray(stats.accepted_steps)
    assert int(np.sum(accepted)) > 0
    rows_of = get_constraint(name).make_tilt_constraint_rows(spec)

    def residual(st):
        rows = rows_of(st, tp.topo, tp.params)
        return float(torch.max(torch.abs(torch.sum(
            rows * torch.stack([st.tilts_in, st.tilts_out])[None], dim=(1, 2, 3)))))

    assert residual(tp.state) > 1e-3  # the seeded start breaks the conditions
    for m in np.flatnonzero(accepted):
        st = dataclasses.replace(tp.state, **{f: getattr(states, f)[m] for f in FIELDS})
        assert residual(st) <= 1e-12, f"member {m}: {residual(st)!r}"


def test_single_field_modules_reproject_the_tilts(port_problems):
    """``bending_tilt`` uses the single field: every trial's tilts are projected onto its
    surface's tangent planes (JAX's ``project_tilts_after_step``), also without enforcement."""
    from membrane_solver_tpu_torch.device import geo as dgeo

    tp = port_problems("family")
    states, _ss, stats = port_run(tp, "family", {}, steps=3)
    accepted = np.asarray(stats.accepted_steps)
    assert int(np.sum(accepted)) > 0

    def normal_part(st):
        geo = dgeo.triangle_geometry(st.positions, tp.topo.tri_rows, tp.topo.tri_valid)
        nrm = dgeo.vertex_normals(geo, tp.topo.tri_valid, tp.topo.corner_csr())
        return max(float(torch.max(torch.abs(torch.sum(getattr(st, f) * nrm, dim=1))))
                   for f in ("tilts", "tilts_in", "tilts_out"))

    assert normal_part(tp.state) > 1e-3
    for m in range(3):
        st = dataclasses.replace(tp.state, **{f: getattr(states, f)[m] for f in FIELDS})
        if accepted[m]:
            assert normal_part(st) <= 1e-14, f"member {m}"
        else:
            for f in ("tilts", "tilts_in", "tilts_out"):
                assert torch.equal(getattr(st, f), getattr(tp.state, f)), f


# ----------------------------------------------------------------------
# every module of the family under vmap, bit for bit
# ----------------------------------------------------------------------
DRIVES_ENERGIES = (
    "tilt_splay_twist_in", "tilt_smoothness_in", "tilt_smoothness_out", "tilt_smoothness_leaflet",
    "tilt_rim_source_in", "tilt_rim_source_out", "tilt_rim_source_bilayer", "tilt_disk_target_in",
    "tilt_disk_target_out", "tilt_disk_contact_in", "tilt_coupling")
MODULE_LANES = {
    **{("energy", n): "family" for n in DRIVES_ENERGIES + MATCH_ENERGIES},
    ("energy", "tilt"): "rect",
    ("energy", "tilt_smoothness"): "rect",
    **{("constraint", n): "family" for n in MATCH_CONSTRAINTS},
}
# the constraints' modes (``chip_smoke.static_variant``)
MODES = {"tilt_leaflet_match_rim": ("average", "in_to_out", "out_to_in"),
         "tilt_vector_match_rim": ("average", "rim_to_disk", "disk_to_rim")}


def _bits(got, want, what):
    assert torch.equal(got, want), f"{what}: max diff {float((got - want).abs().max()):.3e}"


def _member_batch(problem, lane):
    """Three members: seeded offsets on the positions' z and on every tilt field."""
    from membrane_solver_tpu_torch.device.state import MeshState
    from membrane_solver_tpu_torch.parallel.sweep import batch_problem

    rng = np.random.default_rng(17)
    params, _pos = members(lane, problem.params, problem.state.positions.numpy())
    batch = batch_problem(problem, params)
    offsets = {f: torch.as_tensor(rng.standard_normal((3,) + tuple(getattr(problem.state, f).shape)))
               for f in FIELDS}
    offsets["positions"][..., :2] = 0.0
    states = MeshState(*(getattr(batch.states, f) + (0.02 if f == "positions" else 0.1)
                         * offsets[f] for f in FIELDS))
    singles = [(MeshState(*(getattr(states, f)[m] for f in FIELDS)),
                {k: v[m] for k, v in batch.params.items()}) for m in range(3)]
    return states, batch.params, singles


def _energy_bits(problem, name, states, params, singles):
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.device.state import MeshState
    from tests._torch_port_harness import module_fn

    fn = module_fn(problem, "energy", name, port=True)
    topo = problem.topo

    def energy(pos, t, tin, tout, p):
        st = MeshState(pos, t, tin, tout)
        return fn(dgeo.triangle_geometry(pos, topo.tri_rows, topo.tri_valid), st, topo, p)

    def value_and_grads(leaves, e):
        if not e.requires_grad:
            return e.detach(), [torch.zeros_like(x) for x in leaves]
        grads = torch.autograd.grad(e.sum(), leaves, allow_unused=True)
        return e.detach(), [torch.zeros_like(x) if g is None else g
                            for g, x in zip(grads, leaves)]

    leaves = [getattr(states, f).clone().requires_grad_(True) for f in FIELDS]
    eb, gb = value_and_grads(leaves, vmap(energy)(*leaves, params))
    for m, (st, p) in enumerate(singles):
        one = [getattr(st, f).clone().requires_grad_(True) for f in FIELDS]
        e, g = value_and_grads(one, energy(*one, p))
        _bits(eb[m], e, f"{name} energy, member {m}")
        for f, a, b in zip(FIELDS, gb, g):
            _bits(a[m], b, f"{name} gradient in {f}, member {m}")


def _constraint_bits(problem, name, states, params, singles):
    from chip_smoke import static_variant
    from membrane_solver_tpu_torch.constraints import get_constraint

    mod, topo = get_constraint(name), problem.topo
    with torch.no_grad():
        for mode in MODES[name]:
            spec = static_variant(problem.spec, f"constraint:{name}", mode)
            rows, enforce = mod.make_tilt_constraint_rows(spec), mod.make_enforce_tilts(spec)
            rb = vmap(lambda s, p: rows(s, topo, p))(states, params)
            out = vmap(lambda s, p: enforce(s, topo, p))(states, params)
            for m, (st, p) in enumerate(singles):
                _bits(rb[m], rows(st, topo, p), f"{name} {mode} rows, member {m}")
                one = enforce(st, topo, p)
                for f in FIELDS:
                    _bits(getattr(out, f)[m], getattr(one, f), f"{name} {mode} {f}, member {m}")


@pytest.mark.parametrize("kind,name", list(MODULE_LANES), ids=[f"{k}-{n}" for k, n in MODULE_LANES])
def test_module_maps_over_members_bit_for_bit(port_problems, kind, name):
    from membrane_solver_tpu_torch.parallel import member_block
    from membrane_solver_tpu_torch.runtime import jit_core
    from membrane_solver_tpu_torch.runtime import tilt_relax as tr

    lane = MODULE_LANES[(kind, name)]
    problem = port_problems(lane)
    spec, topo = problem.spec, problem.topo
    listed = spec.energy_modules if kind == "energy" else spec.constraint_modules
    assert name in listed
    assert name in (member_block.ENERGY_MODULES if kind == "energy"
                    else member_block.CONSTRAINT_MODULES)
    states, params, singles = _member_batch(problem, lane)
    if kind == "energy":
        _energy_bits(problem, name, states, params, singles)
    else:
        _constraint_bits(problem, name, states, params, singles)
    # the whole lane: energy, projected shape gradient, shape and tilt enforcement
    E, g = member_block.make_member_energy_and_grad(spec)(states, topo, params)
    single = jit_core.make_energy_and_grad(spec)
    enforcer = jit_core.make_constraint_enforcer(spec)
    tilt_enforcer = tr.make_tilt_enforcer(spec)

    def enforced(s, p):
        if enforcer is not None:
            s = enforcer(s, topo, p, context="minimize")
        return tilt_enforcer(s, topo, p)

    with torch.no_grad():
        out = vmap(enforced)(states, params)
    for m, (st, p) in enumerate(singles):
        e1, g1 = single(st, topo, p)
        _bits(E[m], e1, f"lane energy, member {m}")
        _bits(g[m], g1, f"projected gradient, member {m}")
        one = enforced(st, p)
        for f in FIELDS:
            _bits(getattr(out, f)[m], getattr(one, f), f"lane enforcement {f}, member {m}")
