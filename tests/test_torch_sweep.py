"""The port's parameter sweep (``parallel/sweep``) against the JAX package's.

Kozlov L0 (177 vertices) with ``seed_host``'s seeded heights and leaflet
tilts (a flat start with zero tilts converges at the first gradient: the
shape gradient is round-off), three members built from it: member m's
positions times 1 + 0.01 m, ``tilt_modulus_in`` times 1 + 0.1 m,
``tilt_thetaB_value`` plus 0.01 m, and an override of
``tilt_rim_source_strength_in``, which the problem does not have and both
packages drop.  Two steps at step size 1e-3 of ``run_sweep`` in both
packages (JAX's vmapped block, no tilt relax) under the default options,
CG with a fixed step, ``enforce_in_line_search``, BFGS and the volume
drift check (no body has a target here: the check runs and never
projects): per member the
stats and the final positions and tilts at rel 1e-10, and the same accept
flags and iteration counts (no Armijo decision flips here; ROADMAP C3).

Not against JAX: member m of the three against a one-member run of member
m at rel 1e-13, distinct parameters give distinct energies, the dropped
override changes no bit, the local-interface modules and the rigid disk
join the batched set (against JAX's ``jax.vmap``, as
``tests/test_torch_sweep_interface.py`` holds them), the ``trace_z``
fallback builds and runs a placed sweep, a one-device ``device_mesh``
gives the unplaced sweep's bits, and
the member-axis entry points under ``torch.func.vmap`` (the CPU twins of
the member-axis kernels) equal the per-member calls bit for bit.  The
member-axis CUDA kernels against the single-member kernels run on the
card only (marker ``cuda``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import vmap

from tests._torch_port_harness import make_minimizer, seed_host, to_np

REL = 1e-10
MEMBER_REL = 1e-13
SEED = 5
STEPS = 2
STEP_SIZE = 1e-3
MISSING_KEY = "tilt_rim_source_strength_in"
OPTIONS = {
    "default": {},
    "cg_fixed": {"stepper": "conjugate_gradient", "step_size_mode": "fixed"},
    "enforce": {"enforce_in_line_search": True},
    "bfgs": {"stepper": "bfgs"},
    "volume_drift": {"volume_drift_check": True},
}
STATS = ("energy", "accepted_energy", "grad_norm", "step_size")
FLAGS = ("step_success", "iterations", "converged", "terminated_early", "zero_step_counter")
FIELDS = ("positions", "tilts_in", "tilts_out")


def members(params, positions, missing=True):
    """(member_params, member_positions): the dilation, modulus and theta_B scan."""
    k_in, theta = float(params["tilt_modulus_in"]), float(params["tilt_thetaB_value"])
    out = []
    for m in range(3):
        p = {"tilt_modulus_in": k_in * (1.0 + 0.1 * m), "tilt_thetaB_value": theta + 0.01 * m}
        if missing:
            p[MISSING_KEY] = 5.0 * (m + 1)
        out.append(p)
    return out, [positions * (1.0 + 0.01 * m) for m in range(3)]


@pytest.fixture(scope="module")
def problems():
    jm = make_minimizer(False)
    seed_host(jm, SEED)
    tm = make_minimizer(True, device="cpu", dtype=torch.float64)
    seed_host(tm, SEED)
    jp, tp = jm.problem(), tm.problem()
    assert MISSING_KEY not in tp.params and MISSING_KEY not in jp.params
    return jp, tp


def port_run(tp, options: dict, missing=True, pick=None, mesh=None):
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    params, positions = members(tp.params, tp.state.positions.numpy(), missing)
    if pick is not None:
        params, positions = params[pick:pick + 1], positions[pick:pick + 1]
    return run_sweep(tp, params, STEPS, step_size=STEP_SIZE,
                     options=MinimizeOptions(**options), member_positions=positions,
                     device_mesh=mesh)


@pytest.fixture(scope="module")
def jax_runs(problems):
    """The JAX sweep per option set, computed once per module."""
    from membrane_solver_tpu.parallel.sweep import run_sweep
    from membrane_solver_tpu.runtime.jit_core import MinimizeOptions

    jp, _tp = problems
    cache = {}

    def get(name):
        if name not in cache:
            params, positions = members(jp.params, np.asarray(jp.state.positions))
            cache[name] = run_sweep(jp, params, STEPS, step_size=STEP_SIZE,
                                    options=MinimizeOptions(**OPTIONS[name]),
                                    member_positions=positions)
        return cache[name]

    return get


def assert_members_close(got, want, n: int, rel: float) -> None:
    (g_states, _g_ss, g_stats), (w_states, _w_ss, w_stats) = got, want
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


@pytest.mark.parametrize("name", list(OPTIONS))
def test_sweep_matches_jax_per_member(problems, jax_runs, name):
    _jp, tp = problems
    got = port_run(tp, OPTIONS[name])
    want = jax_runs(name)
    assert_members_close(got, want, tp.n_vertices, REL)
    stats = got[2]
    assert np.asarray(stats.iterations).tolist() == [STEPS] * 3
    # every member took a real step: the sweep is not converged at the start
    assert np.all(np.asarray(stats.grad_norm) > 1.0)
    moved = to_np(got[0].positions) - np.stack(members(tp.params, tp.state.positions.numpy())[1])
    assert float(np.max(np.abs(moved))) > 0.0


def test_stats_and_states_carry_the_member_axis(problems):
    _jp, tp = problems
    states, ss, stats = port_run(tp, OPTIONS["bfgs"])
    n = tp.n_vertices
    for f in dataclasses.fields(states):
        assert tuple(getattr(states, f.name).shape) == (3, n, 3)
    assert tuple(ss.H.shape) == (3, 3 * n, 3 * n)
    assert ss.have_prev.tolist() == np.asarray(stats.step_success).tolist()
    for f in dataclasses.fields(stats):
        assert np.asarray(getattr(stats, f.name)).shape == (3,), f.name


@pytest.mark.parametrize("name", ["default", "cg_fixed", "bfgs"])
def test_member_equals_its_single_run(problems, name):
    _jp, tp = problems
    batched = port_run(tp, OPTIONS[name])
    for m in range(3):
        single = port_run(tp, OPTIONS[name], pick=m)
        picked = (dataclasses.replace(batched[0], **{
            f.name: getattr(batched[0], f.name)[m:m + 1] for f in dataclasses.fields(batched[0])}),
            None,
            dataclasses.replace(batched[2], **{
                f.name: np.asarray(getattr(batched[2], f.name))[m:m + 1]
                for f in dataclasses.fields(batched[2])}))
        assert_members_close(single, picked, tp.n_vertices, MEMBER_REL)


def test_distinct_parameters_give_distinct_energies(problems):
    _jp, tp = problems
    e = np.asarray(port_run(tp, OPTIONS["default"])[2].energy)
    assert np.all(np.isfinite(e))
    assert len(np.unique(np.round(e, 9))) == len(e)


def test_missing_override_key_changes_nothing(problems):
    _jp, tp = problems
    with_key, without = port_run(tp, OPTIONS["default"]), port_run(tp, OPTIONS["default"], False)
    for f in FIELDS:
        assert torch.equal(getattr(with_key[0], f), getattr(without[0], f)), f
    for key in STATS + FLAGS:
        assert np.array_equal(np.asarray(getattr(with_key[2], key)),
                              np.asarray(getattr(without[2], key))), key


def test_two_runs_give_the_same_bits(problems):
    _jp, tp = problems
    a, b = port_run(tp, OPTIONS["cg_fixed"]), port_run(tp, OPTIONS["cg_fixed"])
    for f in FIELDS:
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f


def test_trace_z_fallback_raises(problems):
    """The ``trace_z`` fallback no longer raises: its spec builds a sweep (its members' second
    line search, ``tests/test_torch_sweep_scaffold.py``) and runs it placed on a device list,
    each member its unplaced run's bits; only a mesh that does not divide the members raises."""
    from membrane_solver_tpu_torch.parallel.sweep import make_sweep_minimize
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    tp = problems[1]
    spec = tp.spec
    trace_z = dataclasses.replace(spec, static_options=spec.static_options + (
        ("shape_scaffold_rejected_step_fallback", "trace_z"),))
    tz = dataclasses.replace(tp, spec=trace_z)
    placed, unplaced = (port_run(tz, OPTIONS["default"], mesh=mesh) for mesh in (["cpu"] * 3,
                                                                                  None))
    for f in FIELDS:
        assert torch.equal(getattr(placed[0], f), getattr(unplaced[0], f)), f
    assert np.asarray(placed[2].trace_z_fallbacks).tolist() == [0, 0, 0]  # no trace rows here
    with pytest.raises(ValueError, match="do not split over 2 devices"):
        port_run(tz, OPTIONS["default"], mesh=["cpu"] * 2)
    assert callable(make_sweep_minimize(trace_z, MinimizeOptions(), device_mesh=["cpu"] * 2))


@pytest.mark.parametrize("kind,name", [
    ("constraint", "rigid_disk"),
    ("energy", "curved_local_interface_law"),
    ("constraint", "curved_local_interface_hard"),
])
def test_module_joins_the_batched_set(problems, kind, name):
    """The module builds a sweep, and mapped over members it matches the JAX package's
    ``jax.vmap`` and its own single calls (``tests/test_torch_sweep_interface.py``)."""
    from membrane_solver_tpu_torch.parallel.sweep import make_sweep_minimize
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions
    from tests.test_torch_sweep_interface import MODULE_ITEMS, assert_module_items

    spec = problems[1].spec
    field = "constraint_modules" if kind == "constraint" else "energy_modules"
    make_sweep_minimize(dataclasses.replace(spec, **{field: getattr(spec, field) + (name,)}),
                        MinimizeOptions())
    assert_module_items(MODULE_ITEMS[name])


def test_device_mesh_raises(problems):
    """A one-device ``device_mesh`` gives the unplaced sweep's bits; a mesh that does not
    divide the members raises ValueError (``tests/test_torch_sweep_placement.py`` places
    members on several devices)."""
    tp = problems[1]
    placed, unplaced = port_run(tp, OPTIONS["bfgs"], mesh=["cpu"]), port_run(tp, OPTIONS["bfgs"])
    for f in FIELDS:
        assert torch.equal(getattr(placed[0], f), getattr(unplaced[0], f)), f
    for key in STATS + FLAGS:
        assert np.array_equal(np.asarray(getattr(placed[2], key)),
                              np.asarray(getattr(unplaced[2], key))), key
    assert torch.equal(placed[1].H, unplaced[1].H)
    with pytest.raises(ValueError, match="3 sweep members do not split over 2 devices"):
        port_run(tp, OPTIONS["default"], mesh=["cpu"] * 2)


# ----------------------------------------------------------------------
# the member-axis entry points under vmap: the CPU twins of the kernels
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def member_inputs(problems):
    """Three members' positions (seeded z offsets) and tilts on the L0 topology."""
    tp = problems[1]
    rng = np.random.default_rng(11)
    x = tp.state.positions.numpy()
    pos = np.stack([x + 0.02 * rng.standard_normal(x.shape) for _ in range(3)])
    tilts = 0.1 * rng.standard_normal(pos.shape)
    return tp.topo, torch.as_tensor(pos), torch.as_tensor(tilts)


def _bits_equal(a, b, what):
    assert torch.equal(a, b), f"{what}: max diff {float((a - b).abs().max()):.3e}"


def test_vmapped_surface_energy_equals_per_member(member_inputs):
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    topo, pos, _t = member_inputs
    csr = topo.corner_csr()

    def energy(x):
        return tk.surface_energy(x, topo.tri_rows, topo.tri_valid, topo.tri_surface_tension, csr,
                                 tk.workspace(topo, x))

    xb = pos.clone().requires_grad_(True)
    eb = vmap(energy)(xb)
    (gb,) = torch.autograd.grad(eb.sum(), xb)
    with torch.no_grad():
        e_nograd = vmap(energy)(pos)
    for m in range(3):
        x = pos[m].clone().requires_grad_(True)
        e = energy(x)
        (g,) = torch.autograd.grad(e, x)
        _bits_equal(eb[m].detach(), e.detach(), "energy")
        _bits_equal(e_nograd[m], e.detach(), "energy without grad")
        _bits_equal(gb[m], g, "gradient")


def test_vmapped_curvature_data_equals_per_member(member_inputs):
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    topo, pos, _t = member_inputs
    csr = topo.corner_csr()
    w = torch.as_tensor(np.random.default_rng(3).standard_normal(pos.shape[1:]))

    def scalar(x):
        cd = tk.curvature_data(x, topo.tri_rows, topo.tri_valid, csr)
        return torch.sum(w * cd.k_vecs) + torch.sum(cd.vertex_areas ** 2)

    xb = pos.clone().requires_grad_(True)
    sb = vmap(scalar)(xb)
    (gb,) = torch.autograd.grad(sb.sum(), xb)
    for m in range(3):
        x = pos[m].clone().requires_grad_(True)
        s = scalar(x)
        (g,) = torch.autograd.grad(s, x)
        _bits_equal(sb[m].detach(), s.detach(), "value")
        _bits_equal(gb[m], g, "backward")


def test_vmapped_divergence_equals_per_member(member_inputs):
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    topo, pos, tilts = member_inputs
    csr = topo.corner_csr()

    def div(x, t):
        d, area, g = tk.p1_triangle_divergence(x, t, topo.tri_rows, topo.tri_valid, csr)
        return torch.sum(d * d), area, g

    tb = tilts.clone().requires_grad_(True)
    sb, ab, gb_ = vmap(div)(pos, tb)
    (dtb,) = torch.autograd.grad(sb.sum(), tb)
    for m in range(3):
        t = tilts[m].clone().requires_grad_(True)
        s, a, g = div(pos[m], t)
        (dt,) = torch.autograd.grad(s, t)
        _bits_equal(sb[m].detach(), s.detach(), "value")
        _bits_equal(ab[m], a, "area")
        _bits_equal(gb_[m], g, "shape gradients")
        _bits_equal(dtb[m], dt, "tilt backward")
    with pytest.raises(ValueError, match="frozen positions"):
        vmap(div, in_dims=(0, None))(pos.clone().requires_grad_(True), tilts[0])


def test_vmapped_vertex_sum_equals_per_member(member_inputs):
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    topo, pos, _t = member_inputs
    csr = topo.corner_csr()
    corners = pos[:, topo.tri_rows]  # (B, T, 3, 3)
    got = vmap(lambda c: vs.vertex_sum(c, csr))(corners)
    twin = vs.members_reference(corners, csr)
    for m in range(3):
        want = vs.vertex_sum(corners[m], csr)
        _bits_equal(got[m], want, "vertex sum")
        _bits_equal(twin[m], want, "members twin")
    geo_b = vmap(lambda x: dgeo.vertex_normals(dgeo.triangle_geometry(
        x, topo.tri_rows, topo.tri_valid), topo.tri_valid, csr))(pos)
    for m in range(3):
        want = dgeo.vertex_normals(dgeo.triangle_geometry(pos[m], topo.tri_rows, topo.tri_valid),
                                   topo.tri_valid, csr)
        _bits_equal(geo_b[m], want, "vertex normals")


def test_member_twins_equal_per_member_twins(member_inputs):
    from membrane_solver_tpu_torch.device import tilt_ops
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk

    topo, pos, tilts = member_inputs
    csr = topo.corner_csr()
    rows, valid = topo.tri_rows, topo.tri_valid
    e, g = tk.surface_energy_members_reference(pos, rows, valid, topo.tri_surface_tension, csr,
                                               True)
    cd = tk.curvature_data_members_reference(pos, rows, valid, csr)
    dv = tk.p1_divergence_members_reference(pos, tilts, rows, valid)
    for m in range(3):
        e1, g1 = tk.surface_energy_reference(pos[m], rows, valid, topo.tri_surface_tension, csr,
                                             True)
        _bits_equal(e[m], e1, "surface energy")
        _bits_equal(g[m], g1, "surface gradient")
        for got, want in zip(cd, tk.curvature_data_reference(pos[m], rows, valid, csr)):
            _bits_equal(got[m], want, "curvature data")
        for got, want in zip(dv, tilt_ops.p1_triangle_divergence(pos[m], tilts[m], rows, valid)):
            _bits_equal(got[m], want, "divergence")


def test_member_launches_refuse_cpu_tensors(member_inputs):
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    topo, pos, tilts = member_inputs
    csr = topo.corner_csr()
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_curvature_data_members(pos, topo.tri_rows, topo.tri_valid, csr)
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_p1_divergence_members(pos, tilts, topo.tri_rows, topo.tri_valid)
    with pytest.raises(ValueError, match="CUDA"):
        vs.launch_members(pos[:, topo.tri_rows], csr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_member_kernels_equal_single_kernels_bit_for_bit(problems, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    tp = problems[1]
    rows, valid = tp.topo.tri_rows.cuda(), tp.topo.tri_valid.cuda()
    from membrane_solver_tpu_torch.device.state import corner_csr

    csr = corner_csr(rows, tp.n_vertices)
    rng = np.random.default_rng(2)
    x = tp.state.positions.numpy()
    pos = torch.as_tensor(np.stack([x + 0.02 * rng.standard_normal(x.shape) for _ in range(3)]),
                          dtype=dtype, device="cuda")
    tilts = torch.as_tensor(0.1 * rng.standard_normal(pos.shape), dtype=dtype, device="cuda")
    tension = tp.topo.tri_surface_tension.to(dtype=dtype, device="cuda")
    ws = tk.MemberWorkspace(3, rows.shape[0], dtype, "cuda")
    e, g = tk.launch_surface_energy_members(pos, rows, valid, tension, csr, ws, True)
    cd = tk.launch_curvature_data_members(pos, rows, valid, csr)
    up = [torch.randn(s, dtype=dtype, device="cuda") for s in ((3, tp.n_vertices, 3),
                                                               (3, tp.n_vertices))]
    bwd = tk.launch_curvature_data_bwd_members(pos, rows, valid, csr, up[0], up[1], None, None)
    dv = tk.launch_p1_divergence_members(pos, tilts, rows, valid)
    vsum = vs.launch_members(pos[:, rows].contiguous(), csr)
    for m in range(3):
        ws1 = tk.Workspace(rows.shape[0], dtype, "cuda")
        e1, g1 = tk.launch_surface_energy(pos[m].contiguous(), rows, valid, tension, csr, ws1, True)
        _bits_equal(e[m], e1[0], "surface energy")
        _bits_equal(g[m], g1, "surface gradient")
        for got, want in zip(cd, tk.launch_curvature_data(pos[m].contiguous(), rows, valid, csr)):
            _bits_equal(got[m], want, "curvature data")
        _bits_equal(bwd[m], tk.launch_curvature_data_bwd(
            pos[m].contiguous(), rows, valid, csr, up[0][m].contiguous(), up[1][m].contiguous(),
            None, None), "curvature backward")
        for got, want in zip(dv, tk.launch_p1_divergence(pos[m].contiguous(),
                                                         tilts[m].contiguous(), rows, valid)):
            _bits_equal(got[m], want, "divergence")
        _bits_equal(vsum[m], vs.launch(pos[m][rows].contiguous(), csr), "vertex sum")
