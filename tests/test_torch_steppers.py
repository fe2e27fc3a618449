"""The port's CG and BFGS steppers and their state against the JAX package's.

``jit_core.stepper_direction`` and ``stepper_update_on_success`` on seeded
float64 arrays, within 1e-12 of the JAX functions: gradient descent, CG
(first step, Polak-Ribiere with per-row reset, the restart interval, fixed
rows) and BFGS (first step, the dense update, the curvature reset, a run
of steps on a quadratic).  Then the Minimizer: the stepper state lives
across ``minimize`` calls (``g10; g10``) until ``invalidate()``,
``set_mesh`` or a stepper switch, and the mesh-quality auto-repair cadence
runs the JAX package's repairs; both as trajectories against JAX.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_harness import assert_close
from membrane_solver_tpu.runtime import jit_core as jcore
from membrane_solver_tpu_torch.runtime import jit_core as tcore

TOL = 1e-12
N = 5  # vertices


def states(kind: str, n: int = N, **fields):
    """(JAX state, port state) of one stepper kind with the same numpy fields."""
    js = jcore.fresh_stepper_state(n, dtype=jnp.float64, kind=kind)
    ts = tcore.fresh_stepper_state(n, kind, dtype=torch.float64)
    jf, tf = {}, {}
    for key, val in fields.items():
        if key == "have_prev":
            jf[key], tf[key] = jnp.asarray(val), bool(val)
        elif key == "iter_count":
            jf[key], tf[key] = jnp.asarray(val, jnp.int32), int(val)
        else:
            jf[key], tf[key] = jnp.asarray(val), torch.as_tensor(val)
    return dataclasses.replace(js, **jf), dataclasses.replace(ts, **tf)


def both_directions(kind, g, js, ts, fixed, pos):
    jd, jss = jcore.stepper_direction(kind, jnp.asarray(g), js, jnp.asarray(fixed),
                                      jnp.asarray(pos))
    td, tss = tcore.stepper_direction(kind, torch.as_tensor(g), ts, torch.as_tensor(fixed),
                                      torch.as_tensor(pos))
    assert_close(td, jd, TOL, f"{kind} direction")
    return jd, jss, td, tss


def test_gd_direction_and_update_are_stateless():
    rng = np.random.default_rng(0)
    g, pos = rng.standard_normal((N, 3)), rng.standard_normal((N, 3))
    js, ts = states("gradient_descent")
    _jd, _jss, td, tss = both_directions("gradient_descent", g, js, ts, np.zeros(N, bool), pos)
    assert tss is ts
    assert torch.equal(td, -torch.as_tensor(g))
    assert tcore.stepper_update_on_success("gradient_descent", ts, td, td, td) is ts


@pytest.mark.parametrize(
    "have_prev,iter_count,fixed_rows",
    [
        (False, 0, ()),  # no history: steepest descent
        (True, 3, ()),  # Polak-Ribiere, some rows reset where beta < 0
        (True, 7, (0, 3)),  # with fixed rows
        (True, tcore.CG_RESTART_INTERVAL, ()),  # restart interval
        (True, 2 * tcore.CG_RESTART_INTERVAL, (1,)),
    ],
)
def test_cg_direction_matches(have_prev, iter_count, fixed_rows):
    rng = np.random.default_rng(1 + iter_count)
    g_prev, d_prev, g = (rng.standard_normal((N, 3)) for _ in range(3))
    g[2], g[4] = 0.5 * g_prev[2], 2.0 * g_prev[4]  # beta -0.25 and 2: both branches
    fixed = np.zeros(N, bool)
    fixed[list(fixed_rows)] = True
    js, ts = states("conjugate_gradient", prev_grad=g_prev, prev_dir=d_prev,
                    have_prev=have_prev, iter_count=iter_count)
    _jd, _jss, td, tss = both_directions("conjugate_gradient", g, js, ts, fixed,
                                         np.zeros((N, 3)))
    assert tss is ts
    assert torch.all(td[torch.as_tensor(fixed)] == 0)
    beta = np.sum(g * (g - g_prev), axis=1) / (np.sum(g_prev * g_prev, axis=1) + 1e-20)
    restart = not have_prev or iter_count % tcore.CG_RESTART_INTERVAL == 0
    if not restart:
        assert np.any(beta < 0) and np.any(beta > 0)
        want = np.where((beta < 0)[:, None], -g, -g + beta[:, None] * d_prev)
    else:
        want = -g
    want[fixed] = 0.0
    assert_close(td, want, TOL, "cg direction vs numpy")


def _bfgs_fields(rng, ys_sign: float):
    """(x, x_prev, g, g_prev) with the sign of y.s chosen."""
    x_prev, g_prev = rng.standard_normal((N, 3)), rng.standard_normal((N, 3))
    s = 0.1 * rng.standard_normal((N, 3))
    M = rng.standard_normal((3 * N, 3 * N))
    A = M @ M.T / (3 * N) + np.eye(3 * N)  # SPD: y = A s gives y.s > 0
    y = ys_sign * (A @ s.reshape(-1)).reshape(N, 3)
    return x_prev + s, x_prev, g_prev + y, g_prev


@pytest.mark.parametrize("case", ["first_step", "update", "update_fixed", "curvature_reset"])
def test_bfgs_direction_matches(case):
    rng = np.random.default_rng(7)
    x, x_prev, g, g_prev = _bfgs_fields(rng, -1.0 if case == "curvature_reset" else 1.0)
    fixed = np.zeros(N, bool)
    if case == "update_fixed":
        fixed[[1, 4]] = True
    H0 = np.eye(3 * N) + 0.05 * np.diag(rng.uniform(size=3 * N))
    js, ts = states("bfgs", prev_grad=g_prev, prev_x=x_prev, H=H0,
                    have_prev=case != "first_step", iter_count=0 if case == "first_step" else 2)
    _jd, jss, td, tss = both_directions("bfgs", g, js, ts, fixed, x)
    assert_close(tss.H, jss.H, TOL, "bfgs H")
    if case == "first_step":
        assert torch.equal(tss.H, torch.as_tensor(H0))
    elif case == "curvature_reset":
        assert torch.equal(tss.H, torch.eye(3 * N, dtype=torch.float64))
    else:
        assert not torch.equal(tss.H, torch.as_tensor(H0))
    assert torch.all(td[torch.as_tensor(fixed)] == 0)


def test_bfgs_steps_on_a_quadratic_match():
    """Four direction/update rounds with exact line searches, H and x compared each round."""
    rng = np.random.default_rng(5)
    n = 3
    M = rng.standard_normal((3 * n, 3 * n))
    A = M @ M.T + 3 * n * np.eye(3 * n)
    fixed = np.zeros(n, bool)
    js, ts = states("bfgs", n=n)
    x = rng.standard_normal((n, 3))
    for _ in range(4):
        g = (A @ x.reshape(-1)).reshape(n, 3)
        jd, js, td, ts = both_directions("bfgs", g, js, ts, fixed, x)
        assert_close(ts.H, js.H, TOL, "bfgs H")
        d = td.numpy()
        assert float(np.sum(d * g)) < 0
        alpha = -float(g.reshape(-1) @ d.reshape(-1)) / float(d.reshape(-1) @ A @ d.reshape(-1))
        js = jcore.stepper_update_on_success("bfgs", js, jnp.asarray(g), jd, jnp.asarray(x))
        ts = tcore.stepper_update_on_success("bfgs", ts, torch.as_tensor(g), td,
                                             torch.as_tensor(x))
        x = x + alpha * d
    assert ts.have_prev and ts.iter_count == 4 == int(js.iter_count)


@pytest.mark.parametrize("kind", ["conjugate_gradient", "bfgs"])
def test_update_on_success_matches(kind):
    rng = np.random.default_rng(9)
    g, d, pos = (rng.standard_normal((N, 3)) for _ in range(3))
    js, ts = states(kind, iter_count=4, have_prev=True)
    j2 = jcore.stepper_update_on_success(kind, js, jnp.asarray(g), jnp.asarray(d),
                                         jnp.asarray(pos))
    t2 = tcore.stepper_update_on_success(kind, ts, torch.as_tensor(g), torch.as_tensor(d),
                                         torch.as_tensor(pos))
    assert t2.have_prev and t2.iter_count == int(j2.iter_count) == 5
    for name in ("prev_grad", "prev_dir", "prev_x"):
        want = getattr(j2, name)
        if want is None:
            assert getattr(t2, name) is None
        else:
            assert_close(getattr(t2, name), want, 0.0, name)


# ----------------------------------------------------------------------
# the Minimizer: stepper state across calls, auto-repair
# ----------------------------------------------------------------------
def contexts(lines, gp=None):
    """(JAX, port) command contexts on meshgen ``cube`` after ``lines``, both float64 on the CPU."""
    import membrane_solver_tpu as jpkg
    import membrane_solver_tpu_torch as tpkg
    from membrane_solver_tpu.commands import CommandContext as JCtx
    from membrane_solver_tpu.commands import execute_command_line as jrun
    from membrane_solver_tpu.meshgen import build as jbuild
    from membrane_solver_tpu_torch.commands import CommandContext as TCtx
    from membrane_solver_tpu_torch.commands import execute_command_line as trun
    from membrane_solver_tpu_torch.meshgen import build as tbuild

    out = []
    for pkg, build, Ctx, run, kw in ((jpkg, jbuild, JCtx, jrun, {}),
                                     (tpkg, tbuild, TCtx, trun, {"device": "cpu"})):
        mesh = pkg.parse_geometry(build("cube"))
        mesh.global_parameters.update(gp or {})
        mn = pkg.Minimizer(mesh, quiet=True, **kw)
        ctx = Ctx(mesh=mesh, minimizer=mn, stepper=mn.stepper)
        for line in lines:
            run(ctx, line)
            ctx.sync_mesh()
        out.append((ctx, run))
    return out


@pytest.mark.parametrize("stepper,steps", [("cg", 10), ("bfgs", 4)])
def test_stepper_history_survives_between_calls(stepper, steps):
    (jctx, jrun), (tctx, trun) = contexts(["r", stepper])
    energies = []
    counts = []
    for _ in range(2):
        jrun(jctx, f"g{steps}")
        trun(tctx, f"g{steps}")
        energies.append((float(tctx.minimizer.compute_energy()),
                         float(jctx.minimizer.compute_energy())))
        counts.append(tctx.minimizer._stepper_state.iter_count)
    for got, want in energies:
        assert got == pytest.approx(want, rel=1e-10)
    # the second call continued the first call's history
    assert counts[0] > 0 and counts[1] > counts[0]
    assert int(jctx.minimizer._stepper_state.iter_count) == counts[1]


def test_stepper_state_dropped_by_invalidate_set_mesh_and_switch():
    from membrane_solver_tpu_torch.commands import execute_command_line

    (_j, _jr), (ctx, _tr) = contexts(["cg", "g3"])
    mn = ctx.minimizer
    assert mn._stepper_state.have_prev
    mn.invalidate()
    assert mn._stepper_state is None
    execute_command_line(ctx, "g3")
    assert mn._stepper_state.have_prev
    mn.set_mesh(mn.mesh)
    assert mn._stepper_state is None and mn._problem is None
    execute_command_line(ctx, "g3")
    execute_command_line(ctx, "bfgs")
    assert mn._stepper_state is None and mn.stepper.name == "bfgs"
    execute_command_line(ctx, "g2")
    assert mn._stepper_state.H is not None


def test_hessian_restores_the_active_stepper_and_its_state():
    from membrane_solver_tpu_torch.commands import execute_command_line

    (jctx, jrun), (ctx, _tr) = contexts(["cg", "g4"])
    before = ctx.minimizer._stepper_state
    execute_command_line(ctx, "hessian 2")
    jrun(jctx, "hessian 2")
    assert ctx.minimizer.stepper.name == "conjugate_gradient"
    assert ctx.minimizer._stepper_state is before
    assert float(ctx.minimizer.compute_energy()) == pytest.approx(
        float(jctx.minimizer.compute_energy()), rel=1e-10)


def test_auto_repair_cadence_matches():
    """Repairs every 2 steps with a threshold every mesh exceeds: the same flips and energies."""
    gp = {"mesh_quality_auto_repair_enabled": True, "mesh_quality_auto_repair_every": 2,
          "mesh_quality_aspect_threshold": 1.0, "mesh_quality_max_repair_passes": 2}
    (jctx, jrun), (tctx, trun) = contexts(["g20", "r"], gp)
    topo0 = sorted((f, tuple(x.edge_indices)) for f, x in tctx.mesh.facets.items())
    jrun(jctx, "g6")
    trun(tctx, "g6")
    jctx.sync_mesh()
    tctx.sync_mesh()
    t_topo = sorted((f, tuple(x.edge_indices)) for f, x in tctx.mesh.facets.items())
    j_topo = sorted((f, tuple(x.edge_indices)) for f, x in jctx.mesh.facets.items())
    assert t_topo != topo0, "the repair must have flipped edges"
    assert t_topo == j_topo
    assert float(tctx.minimizer.compute_energy()) == pytest.approx(
        float(jctx.minimizer.compute_energy()), rel=1e-10)
    np.testing.assert_allclose(tctx.mesh.positions_array(), jctx.mesh.positions_array(),
                               rtol=0, atol=1e-10)
