"""The parameter sweep over the shape family (``parallel/sweep``) against the JAX package's.

Three lanes on the CPU at float64, each with three members (member m's
positions times 1 + 0.001 m and scanned scalar parameters):

- ``vesicle``: the Helfrich vesicle (meshgen cube, ``surface`` +
  ``bending``, hard ``volume``) after two triangle refines (194 vertices)
  with ``seed_host``'s seeded heights (the refined cube is full of exact
  right angles, Meyer branch ties where the bending gradient jumps, and
  XLA:CPU's batched arithmetic may take either side of one);
  ``bending_modulus`` times 1 + 0.1 m, ``intrinsic_curvature`` plus 0.1 m,
  ``volume_tolerance`` 1e-9 (so the drift check projects);
- ``square``: meshgen ``square_to_circle`` at n = 6 (``surface`` +
  ``line_tension`` under the hard ``global_area``), ``target_surface_area``
  times 1 + 0.01 m;
- ``flat``: ``tools/record_module_parity.flat_lane_dict()`` (the flat disk
  with tagged ``line_tension``, ``edge_length_penalty`` and ``expression``
  entities) with the rest of the list: a body over every facet (``volume``
  in penalty mode, ``body_area_penalty``, the hard ``body_area``), a hard
  ``perimeter`` on the boundary loop, ``fix_facet_area`` on two facets, an
  ``expression`` constraint, ``fixed_plane``, ``gaussian_curvature``,
  ``jordan_area``, a fixed vertex, and the reference's placeholders
  (``edge``, ``fix_facet_angle``, ``fix_vertex_position``, both
  ``dummy_module``\\ s); seeded heights; five moduli times 1 + 0.1 m.

Against JAX's ``run_sweep`` (its vmapped block on XLA:CPU), five sweeps:
the vesicle under the default options, under ``enforce_in_line_search``
with CG at a fixed step, and under ``volume_drift_check`` with BFGS; the
square and the flat lane with ``enforce_in_line_search``.  Per member the
stats and final positions at rel 1e-10, equal flags and iterations (no
Armijo decision flips on these lanes; ROADMAP C3); the vesicle accepts
member-steps.

Not against JAX: member m against a one-member run in bits; the drift
check's projection; for each of the twenty modules, its energy and
gradient or its enforcement and rows, and the whole projected gradient and
enforcement, under ``torch.func.vmap`` equal bit for bit to the per-member
calls; the placeholders change nothing; the area constraints'
``surface_energy_and_gradient`` under ``vmap`` equal in bits to its
per-member calls (its CUDA route against the single kernel on the card
only, marker ``cuda``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.func import vmap

from tests._torch_port_harness import make_vesicle_minimizer, module_fn, seed_host, to_np

REL = 1e-10
SEED = 5
STEP_SIZE = 1e-3
STATS = ("energy", "accepted_energy", "grad_norm", "step_size")
FLAGS = ("step_success", "iterations", "converged", "terminated_early", "zero_step_counter")
FLAT_KEYS = ("surface_tension", "jordan_stiffness", "area_stiffness", "volume_stiffness",
             "edge_stiffness")
PLACEHOLDER_CONSTRAINTS = ("edge", "fix_facet_angle", "fix_vertex_position", "dummy_module")
FLAT_FIXED_VERTEX = 3
ENFORCE = {"enforce_in_line_search": True}
# (lane, options name, MinimizeOptions arguments, steps): the five JAX sweeps
JAX_CASES = [
    ("vesicle", "default", {}, 3),
    ("vesicle", "enforce_cg_fixed", {"enforce_in_line_search": True,
                                     "stepper": "conjugate_gradient",
                                     "step_size_mode": "fixed"}, 3),
    ("vesicle", "drift_bfgs", {"volume_drift_check": True, "stepper": "bfgs"}, 3),
    ("square", "enforce", ENFORCE, 3),
    ("flat", "enforce", ENFORCE, 2),
]


def flat_all_dict() -> dict:
    """The flat lane with the rest of the shape family's modules (see the module docstring)."""
    import membrane_solver_tpu_torch as tpkg
    from tools.record_module_parity import flat_lane_dict

    data = flat_lane_dict()
    mesh = tpkg.parse_geometry(json.loads(json.dumps(data)))
    mesh.build_connectivity_maps()
    loop = sorted(eid for eid, facets in mesh.edge_to_facets.items() if len(facets) == 1)
    pos = {vid: np.asarray(v.position) for vid, v in mesh.vertices.items()}
    perimeter = sum(float(np.linalg.norm(pos[mesh.edges[e].head_index]
                                         - pos[mesh.edges[e].tail_index])) for e in loop)
    area = mesh.compute_total_surface_area()
    data["global_parameters"].update({
        "volume_constraint_mode": "penalty", "volume_stiffness": 3.0, "area_stiffness": 2.5,
        "perimeter_constraints": [{"edges": loop, "target_perimeter": 1.01 * perimeter}]})
    data["bodies"] = {"0": {"faces": list(range(len(data["faces"]))), "target_volume": 0.05,
                            "target_area": 1.01 * area, "area_target": 0.95 * area}}
    for fid in (5, 40):
        data["faces"][fid] = list(data["faces"][fid]) + [
            {"target_area": 1.1 * mesh.facet_area(mesh.facets[fid])}]

    def add_options(vid, **opts):
        v = data["vertices"][vid]
        data["vertices"][vid] = list(v[:3]) + [{**(v[3] if len(v) > 3 else {}), **opts}]

    add_options(10, constraint_expression="x*x + y*y",
                constraint_target=1.02 * float(pos[10][0] ** 2 + pos[10][1] ** 2))
    add_options(FLAT_FIXED_VERTEX, fixed=True)
    data["energy_modules"] = ["surface", "line_tension", "jordan_area", "edge_length_penalty",
                              "expression", "gaussian_curvature", "volume", "body_area_penalty",
                              "dummy_module"]
    data["constraint_modules"] = ["body_area", "perimeter", "fixed_plane", "fix_facet_area",
                                  "expression", *PLACEHOLDER_CONSTRAINTS]
    return data


def _minimizer(lane: str, port: bool):
    if lane == "vesicle":
        mn = (make_vesicle_minimizer(True, 2, dtype=torch.float64) if port
              else make_vesicle_minimizer(False, 2))
        seed_host(mn, SEED)
        return mn
    if port:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.meshgen import build

        kw = {"device": "cpu", "dtype": torch.float64}
    else:
        import membrane_solver_tpu as pkg
        from membrane_solver_tpu.meshgen import build

        kw = {}
    data = build("square_to_circle", n=6) if lane == "square" else flat_all_dict()
    mn = pkg.Minimizer(pkg.parse_geometry(json.loads(json.dumps(data))), quiet=True, **kw)
    if lane == "flat":
        seed_host(mn, SEED)
    return mn


def members(lane: str, params, positions) -> tuple[list, list]:
    """(member_params, member_positions) of a lane, from either package's problem."""
    base = {k: float(v) for k, v in params.items()}
    if lane == "vesicle":
        out = [{"bending_modulus": base["bending_modulus"] * (1.0 + 0.1 * m),
                "intrinsic_curvature": base["intrinsic_curvature"] + 0.1 * m,
                "volume_tolerance": 1e-9} for m in range(3)]
    elif lane == "square":
        out = [{"target_surface_area": base["target_surface_area"] * (1.0 + 0.01 * m)}
               for m in range(3)]
    else:
        out = [{k: base[k] * (1.0 + 0.1 * m) for k in FLAT_KEYS} for m in range(3)]
    return out, [positions * (1.0 + 0.001 * m) for m in range(3)]


@pytest.fixture(scope="module")
def port_problems():
    cache = {}

    def get(lane):
        if lane not in cache:
            cache[lane] = _minimizer(lane, True).problem()
        return cache[lane]

    return get


@pytest.fixture(scope="module")
def jax_problems():
    cache = {}

    def get(lane):
        if lane not in cache:
            cache[lane] = _minimizer(lane, False).problem()
        return cache[lane]

    return get


def port_run(problem, lane: str, options: dict, steps: int, pick=None):
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    params, positions = members(lane, problem.params, problem.state.positions.numpy())
    if pick is not None:
        params, positions = params[pick:pick + 1], positions[pick:pick + 1]
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
    g, w = to_np(g_states.positions)[:, :n], to_np(w_states.positions)[:, :n]
    for m in range(w.shape[0]):
        scale = max(float(np.max(np.abs(w[m]))), 1.0)
        err = float(np.max(np.abs(g[m] - w[m])))
        assert err <= rel * scale, f"positions member {m}: {err:.3e} > {rel:.0e} * {scale:.3e}"


@pytest.mark.parametrize("lane,name,options,steps", JAX_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in JAX_CASES])
def test_sweep_matches_jax_per_member(port_problems, jax_problems, lane, name, options, steps):
    from membrane_solver_tpu.parallel.sweep import run_sweep
    from membrane_solver_tpu.runtime.jit_core import MinimizeOptions

    tp, jp = port_problems(lane), jax_problems(lane)
    got = port_run(tp, lane, options, steps)
    params, positions = members(lane, jp.params, np.asarray(jp.state.positions))
    want = run_sweep(jp, params, steps, step_size=STEP_SIZE, options=MinimizeOptions(**options),
                     member_positions=positions)
    assert_members_close(got, want, tp.n_vertices, REL)
    stats = got[2]
    assert np.asarray(stats.iterations).tolist() == [steps] * 3
    assert not np.any(np.asarray(stats.converged))
    if lane == "vesicle":
        assert int(np.sum(np.asarray(stats.accepted_steps))) > 0


def _volume_errors(problem, states) -> np.ndarray:
    from membrane_solver_tpu_torch.device import geo as dgeo

    topo = problem.topo
    vols = vmap(lambda x: dgeo.body_volumes(x, topo.tri_rows, topo.tri_valid, topo.tri_body,
                                            topo.body_valid.shape[0]))(states.positions)
    target = topo.body_target_volume
    return to_np(torch.abs(vols - target) / torch.abs(target))[:, 0]


def test_drift_check_projects_the_members_volumes(port_problems):
    """BFGS without per-trial enforcement drifts past 1e-9; the drift check projects it back."""
    tp = port_problems("vesicle")
    _lane, _name, drift, steps = JAX_CASES[2]
    free = port_run(tp, "vesicle", {"stepper": "bfgs"}, steps)
    checked = port_run(tp, "vesicle", drift, steps)
    assert np.max(_volume_errors(tp, free[0])) > 1e-9
    assert np.max(_volume_errors(tp, checked[0])) <= 1e-9


@pytest.mark.parametrize("lane,options,steps", [("vesicle", {}, 3), ("square", ENFORCE, 3),
                                                ("flat", ENFORCE, 2)],
                         ids=["vesicle", "square", "flat"])
def test_member_equals_its_single_run(port_problems, lane, options, steps):
    """Member m is its one-member run's bits: every state field, stat and flag."""
    tp = port_problems(lane)
    batched = port_run(tp, lane, options, steps)
    for m in range(3):
        single = port_run(tp, lane, options, steps, pick=m)
        for f in dataclasses.fields(batched[0]):
            assert torch.equal(getattr(batched[0], f.name)[m], getattr(single[0], f.name)[0]), \
                f"{lane} member {m}: {f.name}"
        for f in dataclasses.fields(batched[2]):
            got = np.asarray(getattr(batched[2], f.name))[m]
            assert got.tobytes() == np.asarray(getattr(single[2], f.name))[0].tobytes(), \
                f"{lane} member {m}: {f.name}"


def test_placeholders_and_fixed_rows_change_nothing(port_problems):
    """The flat lane's sweep with and without the reference's placeholders: the same bits;
    its fixed vertex stays where each member put it."""
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    tp = port_problems("flat")
    spec = tp.spec
    bare = dataclasses.replace(tp, spec=dataclasses.replace(
        spec, energy_modules=tuple(n for n in spec.energy_modules if n != "dummy_module"),
        constraint_modules=tuple(n for n in spec.constraint_modules
                                 if n not in PLACEHOLDER_CONSTRAINTS)))
    params, positions = members("flat", tp.params, tp.state.positions.numpy())
    runs = [run_sweep(p, params, 2, step_size=STEP_SIZE, options=MinimizeOptions(**ENFORCE),
                      member_positions=positions) for p in (tp, bare)]
    (a_states, _a, a_stats), (b_states, _b, b_stats) = runs
    assert torch.equal(a_states.positions, b_states.positions)
    for f in dataclasses.fields(a_stats):
        assert np.array_equal(np.asarray(getattr(a_stats, f.name)),
                              np.asarray(getattr(b_stats, f.name))), f.name
    row = list(tp.vertex_ids).index(FLAT_FIXED_VERTEX)
    assert bool(tp.topo.fixed_mask[row])
    start = torch.as_tensor(np.stack(positions))[:, row]
    assert torch.equal(a_states.positions[:, row], start)
    assert int(np.sum(np.asarray(a_stats.accepted_steps))) > 0


# ----------------------------------------------------------------------
# every module of the batched set under vmap, bit for bit
# ----------------------------------------------------------------------
MODULE_LANES = {
    ("energy", "bending"): "vesicle",
    ("constraint", "volume"): "vesicle",
    ("energy", "volume"): "flat",
    ("energy", "gaussian_curvature"): "flat",
    ("constraint", "global_area"): "square",
    ("constraint", "body_area"): "flat",
    ("energy", "line_tension"): "square",
    ("constraint", "perimeter"): "flat",
    ("constraint", "fixed_plane"): "flat",
    ("constraint", "fix_facet_area"): "flat",
    ("energy", "body_area_penalty"): "flat",
    ("energy", "edge_length_penalty"): "flat",
    ("energy", "jordan_area"): "flat",
    ("energy", "expression"): "flat",
    ("constraint", "expression"): "flat",
    ("constraint", "edge"): "flat",
    ("constraint", "fix_facet_angle"): "flat",
    ("constraint", "fix_vertex_position"): "flat",
    ("energy", "dummy_module"): "flat",
    ("constraint", "dummy_module"): "flat",
}


def _bits(got, want, what):
    assert torch.equal(got, want), f"{what}: max diff {float((got - want).abs().max()):.3e}"


def _member_batch(problem, lane):
    from membrane_solver_tpu_torch.device.state import MeshState
    from membrane_solver_tpu_torch.parallel.sweep import batch_problem

    rng = np.random.default_rng(17)
    x = problem.state.positions.numpy()
    params, _pos = members(lane, problem.params, x)
    pos = [x + 0.01 * rng.standard_normal(x.shape) for _ in range(3)]
    batch = batch_problem(problem, params, pos)
    singles = [(MeshState(*(getattr(batch.states, f.name)[m]
                            for f in dataclasses.fields(MeshState))),
                {k: v[m] for k, v in batch.params.items()}) for m in range(3)]
    return batch, singles


def _energy_bits(problem, name, batch, singles):
    from membrane_solver_tpu_torch.device import geo as dgeo

    fn = module_fn(problem, "energy", name, port=True)
    topo = problem.topo

    def energy(x, st, p):
        geo = dgeo.triangle_geometry(x, topo.tri_rows, topo.tri_valid)
        return fn(geo, dataclasses.replace(st, positions=x), topo, p)

    def value_and_grad(x, e):
        if not e.requires_grad:
            return e.detach(), torch.zeros_like(x)
        (g,) = torch.autograd.grad(e.sum(), (x,))
        return e.detach(), g

    xb = batch.states.positions.clone().requires_grad_(True)
    eb, gb = value_and_grad(xb, vmap(energy)(xb, batch.states, batch.params))
    for m, (st, p) in enumerate(singles):
        x = st.positions.clone().requires_grad_(True)
        e, g = value_and_grad(x, energy(x, st, p))
        _bits(eb[m], e, f"{name} energy, member {m}")
        _bits(gb[m], g, f"{name} gradient, member {m}")


def _constraint_bits(problem, name, batch, singles):
    from membrane_solver_tpu_torch.constraints import get_constraint

    spec, topo = problem.spec, problem.topo
    mod = get_constraint(name)
    maker = getattr(mod, "make_enforce", None)
    enforce = maker(spec) if maker is not None else getattr(mod, "enforce", None)
    maker = getattr(mod, "make_constraint_gradient_rows", None)
    rows = maker(spec) if maker is not None else getattr(mod, "constraint_gradient_rows", None)
    with torch.no_grad():
        if enforce is not None:
            for context in ("minimize", "mesh_operation"):
                out = vmap(lambda s, p: enforce(s, topo, p, context=context))(batch.states,
                                                                              batch.params)
                for m, (st, p) in enumerate(singles):
                    _bits(out.positions[m], enforce(st, topo, p, context=context).positions,
                          f"{name} enforcement ({context}), member {m}")
        if rows is not None:
            out = vmap(lambda s, p: rows(s, topo, p))(batch.states, batch.params)
            for m, (st, p) in enumerate(singles):
                _bits(out[m], rows(st, topo, p), f"{name} rows, member {m}")


@pytest.mark.parametrize("kind,name", list(MODULE_LANES), ids=[f"{k}-{n}" for k, n in MODULE_LANES])
def test_module_maps_over_members_bit_for_bit(port_problems, kind, name):
    from membrane_solver_tpu_torch.parallel import member_block
    from membrane_solver_tpu_torch.runtime import jit_core

    lane = MODULE_LANES[(kind, name)]
    problem = port_problems(lane)
    spec, topo = problem.spec, problem.topo
    listed = spec.energy_modules if kind == "energy" else spec.constraint_modules
    assert name in listed
    assert name in (member_block.ENERGY_MODULES if kind == "energy"
                    else member_block.CONSTRAINT_MODULES)
    batch, singles = _member_batch(problem, lane)
    if kind == "energy":
        _energy_bits(problem, name, batch, singles)
    else:
        _constraint_bits(problem, name, batch, singles)
    # the whole lane: energy, projected shape gradient and enforcement
    E, g = member_block.make_member_energy_and_grad(spec)(batch.states, topo, batch.params)
    single = jit_core.make_energy_and_grad(spec)
    enforcer = jit_core.make_constraint_enforcer(spec)
    with torch.no_grad():
        enforced = vmap(lambda s, p: enforcer(s, topo, p, context="minimize"))(batch.states,
                                                                               batch.params)
    for m, (st, p) in enumerate(singles):
        e1, g1 = single(st, topo, p)
        _bits(E[m], e1, f"lane energy, member {m}")
        _bits(g[m], g1, f"projected gradient, member {m}")
        _bits(enforced.positions[m], enforcer(st, topo, p, context="minimize").positions,
              f"lane enforcement, member {m}")


def test_the_batched_set_holds_the_shape_family(port_problems):
    """Every listed module is admitted, and so is the physical-edge placement (its sweep:
    ``tests/test_torch_sweep_physical_edge.py``); a module outside the batched set still
    raises, naming ROADMAP A6."""
    from membrane_solver_tpu_torch.parallel import member_block

    spec = port_problems("flat").spec
    energies = tuple(n for k, n in MODULE_LANES if k == "energy")
    constraints = tuple(n for k, n in MODULE_LANES if k == "constraint")
    member_block.check_batched_modules(dataclasses.replace(
        spec, energy_modules=spec.energy_modules + energies,
        constraint_modules=spec.constraint_modules + constraints))
    physical = dataclasses.replace(spec, static_options=spec.static_options + (
        ("rim_slope_match_mode", "physical_edge_staggered_v1"),))
    member_block.check_batched_modules(physical)
    outside = dataclasses.replace(spec, constraint_modules=spec.constraint_modules
                                  + ("no_such_constraint",))
    with pytest.raises(NotImplementedError,
                       match="constraint module 'no_such_constraint'.*ROADMAP A6"):
        member_block.check_batched_modules(outside)


TILT_FIELD_FAMILY = {
    "energy": ("tilt", "tilt_smoothness", "tilt_coupling", "tilt_smoothness_leaflet",
               "tilt_smoothness_in", "tilt_smoothness_out", "tilt_splay_twist_in",
               "tilt_disk_target_in", "tilt_disk_target_out", "tilt_rim_source_in",
               "tilt_rim_source_out", "tilt_rim_source_bilayer", "tilt_disk_contact_in",
               "bending_tilt", "mean_curvature_tilt", "rim_slope_match_out"),
    "constraint": ("tilt_leaflet_match_rim", "tilt_vector_match_rim"),
}
# the modules that left the pending set (tests/test_torch_sweep_interface.py
# and tests/test_torch_sweep_rigid_disk.py hold them against JAX's sweep)
JOINED = {"energy": ("curved_local_interface_law", "curved_local_interface_penalty"),
          "constraint": ("curved_local_interface_hard", "curved_local_interface_match",
                         "rigid_disk")}


def test_the_batched_set_holds_the_tilt_field_family(port_problems):
    """The family's sixteen energies and two constraints are admitted, and so are the
    local-interface family, rigid_disk, the physical-edge shells
    (``local_interface_shells`` and ``rim_slope_match_mode`` ``physical_edge_staggered_v1``)
    and the ``trace_z`` fallback; no module is pending."""
    from membrane_solver_tpu_torch.parallel import member_block

    for gone in ("TILT_FIELD_ITEM", "INTERFACE_ITEM", "RIGID_DISK_ITEM", "PHYSICAL_EDGE_ITEM",
                 "TRACE_Z_ITEM"):
        assert not hasattr(member_block, gone)
    assert not member_block.PENDING_CONSTRAINT
    spec = port_problems("flat").spec
    member_block.check_batched_modules(dataclasses.replace(
        spec, energy_modules=spec.energy_modules + TILT_FIELD_FAMILY["energy"] + JOINED["energy"],
        constraint_modules=spec.constraint_modules + TILT_FIELD_FAMILY["constraint"]
        + JOINED["constraint"]))
    shells = dataclasses.replace(spec, constraint_modules=spec.constraint_modules
                                 + ("local_interface_shells",), static_options=spec.static_options
                                 + (("rim_slope_match_mode", "physical_edge_staggered_v1"),
                                    ("shape_scaffold_rejected_step_fallback", "trace_z")))
    member_block.check_batched_modules(shells)


# ----------------------------------------------------------------------
# the area constraints' energy-and-gradient call over the members
# ----------------------------------------------------------------------
def _area_inputs(problem):
    rng = np.random.default_rng(23)
    x = problem.state.positions.numpy()
    pos = torch.as_tensor(np.stack([x + 0.02 * rng.standard_normal(x.shape) for _ in range(3)]))
    topo = problem.topo
    per_member = torch.as_tensor(rng.uniform(0.5, 1.5, (3, topo.tri_rows.shape[0])))
    return topo, pos, per_member


def test_area_route_equals_per_member_calls(port_problems):
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    topo, pos, per_member = _area_inputs(port_problems("square"))
    csr = topo.corner_csr()
    unit = torch.ones_like(topo.tri_surface_tension)
    before = dict(tk.LAUNCHES)

    def call(x, tension):
        return tk.surface_energy_and_gradient(x, topo.tri_rows, topo.tri_valid, tension, csr,
                                              tk.workspace(topo, x))

    a, g = vmap(lambda x: call(x, unit))(pos)
    a2, g2 = vmap(call)(pos, per_member)
    twin_a, twin_g = tk.surface_energy_members_reference(pos, topo.tri_rows, topo.tri_valid,
                                                         unit, csr, True)
    for m in range(3):
        a1, g1 = call(pos[m], unit)
        _bits(a[m], a1, "area")
        _bits(g[m], g1, "area gradient")
        _bits(twin_a[m], a1, "member twin area")
        _bits(twin_g[m], g1, "member twin gradient")
        a1, g1 = call(pos[m], per_member[m])
        _bits(a2[m], a1, "per-member tension")
        _bits(g2[m], g1, "per-member tension gradient")
    assert not g.requires_grad
    assert tk.LAUNCHES == before  # the CPU twins: no kernel launch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_area_route_equals_the_single_kernel(port_problems, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from membrane_solver_tpu_torch.device.state import corner_csr
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    topo, pos, _t = _area_inputs(port_problems("square"))
    rows, valid = topo.tri_rows.cuda(), topo.tri_valid.cuda()
    csr = corner_csr(rows, pos.shape[1])
    pos = pos.to(dtype=dtype, device="cuda")
    unit = torch.ones(rows.shape[0], dtype=dtype, device="cuda")
    before = tk.LAUNCHES["surface_area_grad_members"]
    a, g = vmap(lambda x: tk.surface_energy_and_gradient(x, rows, valid, unit, csr))(pos)
    assert tk.LAUNCHES["surface_area_grad_members"] == before + 1
    for m in range(3):
        ws = tk.Workspace(rows.shape[0], dtype, "cuda")
        e1, g1 = tk.launch_surface_energy(pos[m].contiguous(), rows, valid, unit, csr, ws, True)
        _bits(a[m], e1[0], "area")
        _bits(g[m], g1, "area gradient")
