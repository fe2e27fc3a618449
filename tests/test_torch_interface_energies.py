"""The single-field bending-tilt, the soft rim matching and the legacy stub against the JAX package.

On the CPU at float64:

- ``bending_tilt`` on meshgen ``rect_tilt_source`` at 10 x 4 with the module
  added to the lane's energies: its recipe ``g5`` as five ``g1`` through
  both packages' command layers (energies within rel 1e-10), and at a
  seeded state with curved positions and tilts, the energy and its
  gradients in the positions and the tilts within 1e-12;
- the soft ``rim_slope_match_out`` energy on meshgen ``kozlov_1disk`` at L0
  (rim and outer rings of 16): with the disk group paired 1:1 (theta per
  vertex, ``local_disk``), with one disk vertex untagged (15 against 16:
  the arc-length mean), and without a disk group (the outer condition
  alone); energy and gradients in the positions and both leaflet tilts
  within 1e-12; the shape gradient acts on heights only;
- ``mean_curvature_tilt``: zero, and its deprecation warning once.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import pytest
import torch
from _torch_port_harness import (
    _pkg,
    assert_close,
    energy_and_grads,
    make_minimizer,
    seeded_pair,
)

REL = 1e-12


def rect_context(port: bool):
    """The rect_tilt_source 10 x 4 lane with bending_tilt, in either package's command context."""
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
    data = build("rect_tilt_source", nx=10, ny=4)
    data["energy_modules"] = list(data["energy_modules"]) + ["bending_tilt"]
    data["global_parameters"]["spontaneous_curvature"] = 0.2
    mesh = pkg.parse_geometry(json.loads(json.dumps(data)))
    mn = pkg.Minimizer(mesh, stepper=make_stepper("gd"),
                       step_size=float(mesh.global_parameters.get("step_size", 1e-3)), tol=1e-6,
                       quiet=True, **kw)
    return CommandContext(mesh=mesh, minimizer=mn, stepper=mn.stepper), execute_command_line


def test_bending_tilt_rect_lane_matches_jax():
    energies = []
    for port in (False, True):
        ctx, run = rect_context(port)
        rows = []
        for _ in range(5):
            run(ctx, "g1")
            ctx.sync_mesh()
            rows.append(float(ctx.minimizer.compute_energy()))
        breakdown = ctx.minimizer.compute_energy_breakdown()
        assert float(breakdown["bending_tilt"]) > 1e-6
        energies.append(rows)
    want, got = energies
    for a, b in zip(got, want, strict=True):
        assert abs(a - b) <= 1e-10 * abs(b), (got, want)


def test_bending_tilt_energy_and_gradients_match_jax():
    jp, tp = (rect_context(port)[0].minimizer.problem() for port in (False, True))
    jst, tst = seeded_pair(jp, seed=12, amp=0.1)
    ej, gj = energy_and_grads(jp, "bending_tilt", jst, port=False)
    et, gt = energy_and_grads(tp, "bending_tilt", tst, port=True)
    assert abs(et - ej) <= REL * abs(ej) and ej > 1e-3
    for k, (a, b) in enumerate(zip(gt, gj, strict=True)):
        assert_close(a, b, REL, f"bending_tilt grad {k}", atol_scale=1e-300)
    assert np.abs(gt[0]).max() > 0 and np.abs(gt[1]).max() > 0  # shape and tilt gradients


RIM_CASES = ["local_disk", "mean_disk", "no_disk"]


def rim_problems(case: str):
    out = []
    for port in (False, True):
        mn = make_minimizer(port, **({"dtype": torch.float64} if port else {}))
        mesh = mn.mesh
        mesh.energy_modules.append("rim_slope_match_out")
        mesh.global_parameters.update({"rim_slope_match_strength": 0.6})
        if case == "no_disk":
            mesh.global_parameters.update({"rim_slope_match_disk_group": None})
        if case == "mean_disk":
            vid = next(v for v in sorted(mesh.vertices)
                       if mesh.vertices[v].options.get("rim_slope_match_group") == "disk")
            mesh.vertices[vid].options.pop("rim_slope_match_group")
        pkg = _pkg(port)[0]
        kw = {"device": "cpu", "dtype": torch.float64} if port else {}
        out.append(pkg.Minimizer(mesh, quiet=True, **kw).problem())
    return out


@pytest.mark.parametrize("case", RIM_CASES)
def test_soft_rim_energy_matches_jax(case):
    jp, tp = rim_problems(case)
    flags = tp.spec.static_of("energy:rim_slope_match_out")
    assert flags[:4] == ("active", case != "no_disk", False, case == "local_disk")
    assert tuple(jp.spec.static_of("energy:rim_slope_match_out"))[:4] == flags[:4]
    jst, tst = seeded_pair(jp, seed=14)
    ej, gj = energy_and_grads(jp, "rim_slope_match_out", jst, port=False)
    et, gt = energy_and_grads(tp, "rim_slope_match_out", tst, port=True)
    assert abs(et - ej) <= REL * abs(ej) and ej > 1e-4
    for k, (a, b) in enumerate(zip(gt, gj, strict=True)):
        assert_close(a, b, REL, f"{case} grad {k}", atol_scale=1e-300)
    # the heights alone are live (about the z normal): no in-plane shape gradient
    assert np.abs(gt[0][:, :2]).max() == 0.0 and np.abs(gt[0][:, 2]).max() > 0.0
    assert (np.abs(gt[2]).max() > 0.0) == (case != "no_disk")


def test_mean_curvature_tilt_is_zero_and_warns_once(caplog):
    from membrane_solver_tpu_torch.energy import mean_curvature_tilt

    jp, tp = rim_problems("local_disk")
    mean_curvature_tilt._warned = False
    with caplog.at_level(logging.WARNING, logger="membrane_solver_tpu_torch"):
        values = [energy_and_grads(tp, "mean_curvature_tilt", tp.state, port=True)
                  for _ in range(2)]
    assert all(e == 0.0 and all(np.abs(g).max() == 0.0 for g in gs) for e, gs in values)
    warnings = [r for r in caplog.records if "mean_curvature_tilt" in r.getMessage()]
    assert len(warnings) == 1
    assert energy_and_grads(jp, "mean_curvature_tilt", jp.state, port=False)[0] == 0.0
