"""Shared set-up for the PyTorch port's parity tests (``tests/test_torch_*.py``).

Both packages are built from the same meshgen dict; the JAX package's
compiled (capacity-padded) arrays go to the port through
``membrane_solver_tpu_torch.device.state.problem_from_numpy``, which drops
the padding rows, so both sides evaluate identical inputs.  Data passes
between the frameworks as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

# the suite runs under pytest-xdist with several workers on one host
torch.set_num_threads(2)

# the kozlov lane's protocol, as tools/record_torch_port_fixture.py defines
# and records it (the bench lane's global parameters and step size)
FIXTURE = Path(__file__).parent / "fixtures" / "torch_port" / "kozlov_L3_f64_jax.json"
PROTOCOL = json.loads(FIXTURE.read_text())["protocol"]
BENCH_GP = PROTOCOL["global_parameters"]
STEP_SIZE = PROTOCOL["step_size"]
# 49 vertices; kozlov_1disk with its default arguments gives 177
SMALL = {"n_sectors": 8, "n_outer_rings": 4, "n_disk_rings": 2}

STATE_FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")


def _pkg(port: bool):
    if port:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.meshgen import build
        from membrane_solver_tpu_torch.runtime import refinement
    else:
        import membrane_solver_tpu as pkg
        from membrane_solver_tpu.meshgen import build
        from membrane_solver_tpu.runtime import refinement
    return pkg, build, refinement


def make_minimizer(port: bool, kw=None, refines: int = 0, gp=None, modules=(), edits=None,
                   **port_kw):
    """The kozlov lane's protocol up to the first step: build, parse, refine.

    ``kw`` are kozlov_1disk arguments (None: its defaults); ``modules`` are
    energy modules added to the mesh's (a protocol's ``extra_energy_modules``);
    ``edits`` a protocol whose module and free-disk changes
    ``chip_smoke.lane_edits`` makes, and whose vertex tags ``chip_smoke.lane_tags``
    sets after the refinements; ``port_kw`` go to the port's Minimizer
    (device, dtype).
    """
    from chip_smoke import lane_edits, lane_tags

    pkg, build, refinement = _pkg(port)
    mesh = pkg.parse_geometry(build("kozlov_1disk", **(kw or {})))
    mesh.global_parameters.update(BENCH_GP if gp is None else gp)
    mesh.energy_modules.extend(m for m in modules if m not in mesh.energy_modules)
    lane_edits(mesh, edits or {})
    if port:
        port_kw.setdefault("device", "cpu")
        mn = pkg.Minimizer(mesh, quiet=True, **port_kw)
    else:
        mn = pkg.Minimizer(mesh, quiet=True)
    mn.step_size = STEP_SIZE
    for _ in range(refines):
        m = refinement.refine_polygonal_facets(mn.mesh)
        m = refinement.refine_triangle_mesh(m)
        mn.mesh = m
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    lane_tags(mn, edits or {})
    return mn


VESICLE_FIXTURE = FIXTURE.parent / "helfrich_cube_L5_f64_jax.json"
VESICLE_PROTOCOL = json.loads(VESICLE_FIXTURE.read_text())["protocol"]


def vesicle_data(port: bool, protocol=None) -> dict:
    """The vesicle lane's input dict (meshgen cube with the protocol's modules)."""
    protocol = VESICLE_PROTOCOL if protocol is None else protocol
    _pkg_, build, _refinement = _pkg(port)
    data = build("cube")
    if protocol["drop_instructions"]:
        data.pop("instructions", None)
    data["energy_modules"] = list(protocol["energy_modules"])
    data["constraint_modules"] = list(protocol["constraint_modules"])
    data["global_parameters"].update(protocol["global_parameters"])
    return data


def make_vesicle_minimizer(port: bool, refines: int, data=None, **port_kw):
    """The Helfrich vesicle protocol up to the first step, with ``refines`` triangle refines.

    As ``tools/record_torch_port_fixture.py`` defines it (the fixture's
    ``protocol`` block): cube -> polygonal refine -> ``refines`` rounds of
    triangle refine, invalidate, enforce constraints after mesh ops.
    ``data`` replaces the input dict (default :func:`vesicle_data`).
    """
    pkg, _build, refinement = _pkg(port)
    data = vesicle_data(port) if data is None else data
    if port:
        port_kw.setdefault("device", "cpu")
        mn = pkg.Minimizer(pkg.parse_geometry(data), quiet=True, **port_kw)
    else:
        mn = pkg.Minimizer(pkg.parse_geometry(data), quiet=True)
    mn.step_size = VESICLE_PROTOCOL["step_size"]
    for _ in range(VESICLE_PROTOCOL["polygonal_refines"]):
        mn.mesh = refinement.refine_polygonal_facets(mn.mesh)
    for _ in range(refines):
        mn.mesh = refinement.refine_triangle_mesh(mn.mesh)
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    return mn


def jax_arrays(problem):
    """(state, topo, params) of a JAX CompiledProblem as numpy mappings."""
    state = {k: np.asarray(getattr(problem.state, k)) for k in STATE_FIELDS}
    topo = {
        f.name: np.asarray(getattr(problem.topo, f.name))
        for f in dataclasses.fields(problem.topo)
        if f.name != "extras"
    }
    topo["extras"] = {k: np.asarray(v) for k, v in problem.topo.extras.items()}
    params = {k: np.asarray(v) for k, v in problem.params.items()}
    return state, topo, params


def port_from_jax(problem, dtype=torch.float64):
    """The port's (state, topo, params) built from a JAX compiled problem."""
    from membrane_solver_tpu_torch.device.state import problem_from_numpy
    from membrane_solver_tpu_torch.energy import get_module

    state, topo, params = jax_arrays(problem)
    vertex_tables = {
        f"energy:{name}/{key}"
        for name in problem.spec.energy_modules
        for key in getattr(get_module(name), "VERTEX_TABLES", ())
    }
    return problem_from_numpy(state, topo, params, vertex_tables=vertex_tables,
                              device="cpu", dtype=dtype)


def perturbation(nv: int, seed: int, amp: float = 0.05):
    """Seeded (positions, tilts_in, tilts_out) offsets for nv rows."""
    rng = np.random.default_rng(seed)
    dpos = np.zeros((nv, 3))
    dpos[:, 2] = amp * rng.standard_normal(nv)
    dpos[:, :2] = 0.2 * amp * rng.standard_normal((nv, 2))
    return dpos, amp * rng.standard_normal((nv, 3)), amp * rng.standard_normal((nv, 3))


def perturbed_pair(problem, seed: int, dtype=torch.float64):
    """(JAX state, port state) with the same seeded offsets on the live rows."""
    nv = problem.n_vertices
    dpos, dtin, dtout = perturbation(nv, seed)
    offsets = {"positions": dpos, "tilts_in": dtin, "tilts_out": dtout}
    jax_fields, port_fields = {}, {}
    for name in STATE_FIELDS:
        arr = np.array(getattr(problem.state, name))
        if name in offsets:
            arr[:nv] += offsets[name]
        jax_fields[name] = jnp.asarray(arr)
        port_fields[name] = torch.as_tensor(arr[:nv], dtype=dtype)
    from membrane_solver_tpu.device.state import MeshState as JaxState
    from membrane_solver_tpu_torch.device.state import MeshState as PortState

    return JaxState(**jax_fields), PortState(**port_fields)


def to_np(x):
    """numpy float64 copy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def assert_close(got, want, rel: float, what: str = "", atol_scale=None):
    """max|got - want| <= rel * max(max|want|, atol_scale or tiny)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    scale = max(scale, atol_scale or 1e-300)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel:.1e} * {scale:.3e}"


def recipe_context(port: bool, name: str, **build_kw):
    """(context, execute_command_line, recipe) for the builder ``name`` in one package.

    The command context is the one ``cli.main`` builds (gradient descent,
    the mesh's step size, tol 1e-6); ``build_kw`` go to the builder.
    """
    if port:
        import membrane_solver_tpu_torch as pkg
        from membrane_solver_tpu_torch.commands import CommandContext, execute_command_line
        from membrane_solver_tpu_torch.meshgen import build
        from membrane_solver_tpu_torch.runtime.steppers import make_stepper

        kw = {"device": "cpu", "dtype": torch.float64}
    else:
        import membrane_solver_tpu as pkg
        from membrane_solver_tpu.commands import CommandContext, execute_command_line
        from membrane_solver_tpu.meshgen import build
        from membrane_solver_tpu.runtime.steppers import make_stepper

        kw = {}
    data = build(name, **build_kw)
    mesh = pkg.parse_geometry(json.loads(json.dumps(data)))
    gp = mesh.global_parameters
    mn = pkg.Minimizer(mesh, stepper=make_stepper("gd"),
                       step_size=float(gp.get("step_size", 1e-3)), tol=1e-6, quiet=True, **kw)
    return (CommandContext(mesh=mesh, minimizer=mn, stepper=mn.stepper), execute_command_line,
            list(data["instructions"]))


def recipe_trace(port: bool, name: str, expand: bool = False, **build_kw) -> list:
    """(command, energy, vertices, facets, step size) after each command of the recipe."""
    from tools.lane_noise_spread import expanded

    ctx, run, recipe = recipe_context(port, name, **build_kw)
    rows = []
    for cmd in expanded(recipe) if expand else recipe:
        run(ctx, cmd)
        ctx.sync_mesh()
        mn = ctx.minimizer
        rows.append((cmd, float(mn.compute_energy()), len(mn.mesh.vertices), len(mn.mesh.facets),
                     float(mn.step_size)))
    return rows


# the kozlov lane's option tests (tests/test_torch_kozlov_*.py): the JAX
# package's own option-test parameters (tests/test_gp_option_parity.py)
OPTION_GP = {
    "tilt_solve_mode": "coupled",
    "tilt_step_size": 0.15,
    "tilt_inner_steps": 6,
    "tilt_tol": 1e-12,
    "step_size": 0.005,
    "step_size_mode": "fixed",
}
# the inner-coupled cap's bands: rim |r - 1| <= 1, near band (2, 5]
BANDS = {"benchmark_disk_radius": 1.0, "benchmark_lambda_value": 1.0}
ABLATION = {
    "curved_theta_objective_ablation_mode": "inner_outer_rescaled",
    "benchmark_geometry_lane": "free_z",
    "benchmark_parameterization": "kh_physical",
    "curved_theta_objective_ablation_inner_scale": 0.5,
    "curved_theta_objective_ablation_outer_scale": 2.0,
    "curved_theta_objective_ablation_contact_scale": 1.5,
}


def option_minimizers(gp: dict, **kw):
    """(JAX, port float64) minimizers of the kozlov lane with ``OPTION_GP`` and ``gp``."""
    full = {**OPTION_GP, **gp}
    return (make_minimizer(False, gp=full, **kw),
            make_minimizer(True, gp=full, dtype=torch.float64, **kw))


def host_state(mn) -> dict:
    """Positions and leaflet tilts of the minimizer's host mesh, by vertex id."""
    verts = mn.mesh.vertices
    return {f: np.array([getattr(verts[v], f) for v in sorted(verts)])
            for f in ("position", "tilt_in", "tilt_out")}


def steps_of(jm, tm, n: int) -> list:
    """Both minimizers ``n`` times ``minimize(1)``: per step (JAX result, port result)."""
    return [(jm.minimize(1), tm.minimize(1)) for _ in range(n)]


def jax_noise_state(gp: dict, n: int, amp: float = 1e-15, **kw) -> dict:
    """The JAX package's host state after ``n`` times ``minimize(1)`` from a start with ``amp`` of z noise.

    Beside the clean run, it measures how far the lane itself moves a
    round-off difference: on these lanes each relax's accept-if-not-worse
    tests amplify it (ROADMAP C3), so a state comparison is bounded by
    that spread (as ``tools/lane_noise_spread.py`` bounds catenoid's).
    The returned dict also holds the noisy run's energy ``breakdown``.
    """
    mn = make_minimizer(False, gp=gp, **kw)
    rng = np.random.default_rng(0)
    for vid in sorted(mn.mesh.vertices):
        mn.mesh.vertices[vid].position[2] += amp * rng.standard_normal()
    mn.invalidate()
    for _ in range(n):
        mn.minimize(1)
    out = host_state(mn)
    out["breakdown"] = {k: float(v) for k, v in mn.compute_energy_breakdown().items()}
    return out


def assert_steps(steps, jm, tm, rel: float, noisy=None) -> None:
    """The same accept flag and energies within ``rel`` at every step; the final states close.

    The final positions and tilts within ``rel`` of their scale, or, given
    ``noisy`` (:func:`jax_noise_state` of the same lane), within twice the
    JAX package's own spread under round-off noise, when that is larger.
    """
    for k, (jr, tr) in enumerate(steps):
        assert tr["step_success"] == bool(jr["step_success"]), f"step {k}: accept flag"
        want = float(jr["energy"])
        assert abs(tr["energy"] - want) <= rel * abs(want), f"step {k}: {tr['energy']} vs {want}"
    want, got = host_state(jm), host_state(tm)
    for f in want:  # the state fields (``noisy`` may hold more)
        scale = max(float(np.max(np.abs(want[f]))), 1.0)
        bound = rel * scale
        if noisy is not None:
            bound = max(bound, 2.0 * float(np.max(np.abs(noisy[f] - want[f]))))
        err = float(np.max(np.abs(got[f] - want[f])))
        assert err <= bound, f"{f}: max abs err {err:.3e} > {bound:.3e}"


def module_fn(problem, kind: str, name: str, port: bool):
    """Either package's energy function (``kind`` energy) or constraint module of ``problem``'s spec."""
    if port:
        from membrane_solver_tpu_torch.constraints import get_constraint
        from membrane_solver_tpu_torch.energy import get_module
    else:
        from membrane_solver_tpu.constraints import get_constraint
        from membrane_solver_tpu.energy import get_module
    if kind != "energy":
        return get_constraint(name)
    module = get_module(name)
    maker = getattr(module, "make_energy", None)
    return maker(problem.spec) if maker is not None else module.energy


ENERGY_FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")


def energy_and_grads(problem, name: str, state, port: bool):
    """(energy, [gradient in each of ``ENERGY_FIELDS``]) of one energy module, as numpy."""
    fn = module_fn(problem, "energy", name, port)
    topo, params = problem.topo, problem.params
    if port:
        from membrane_solver_tpu_torch.device import geo as tgeo

        leaves = [getattr(state, f).detach().clone().requires_grad_(True) for f in ENERGY_FIELDS]
        st = dataclasses.replace(state, **dict(zip(ENERGY_FIELDS, leaves)))
        e = fn(tgeo.triangle_geometry(st.positions, topo.tri_rows, topo.tri_valid), st, topo,
               params)
        grads = (torch.autograd.grad(e, leaves, allow_unused=True) if e.requires_grad
                 else [None] * len(leaves))
        return float(e.detach()), [np.zeros(tuple(x.shape)) if g is None else to_np(g)
                          for g, x in zip(grads, leaves)]
    import jax

    from membrane_solver_tpu.device import geo as jgeo

    nv = problem.n_vertices

    def f(*fields):
        st = dataclasses.replace(state, **dict(zip(ENERGY_FIELDS, fields)))
        return fn(jgeo.triangle_geometry(st.positions, topo.tri_rows, topo.tri_valid), st, topo,
                  params)

    e, grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(
        *(getattr(state, k) for k in ENERGY_FIELDS))
    return float(e), [to_np(g)[:nv] for g in grads]


def seeded_pair(problem, seed: int, amp: float = 0.05, dtype=torch.float64):
    """(JAX state, port state): :func:`perturbed_pair` plus seeded single-field tilts."""
    jst, tst = perturbed_pair(problem, seed, dtype=dtype)
    nv = problem.n_vertices
    tilts = np.array(jst.tilts)
    tilts[:nv] += amp * np.random.default_rng(seed + 1).standard_normal((nv, 3))
    return (dataclasses.replace(jst, tilts=jnp.asarray(tilts)),
            dataclasses.replace(tst, tilts=torch.as_tensor(tilts[:nv], dtype=dtype)))
