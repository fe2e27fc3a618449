"""The port's Minimizer end to end against the JAX package, on the CPU.

Five calls of ``minimize(1)`` with the bench lane's parameters must match
the JAX package at float64 to rel 1e-9, on the plain kozlov lane (disk and
rim rings pair 1:1) and on the small lane refined once (mean-field disk
coupling).  Also: the port never imports JAX, the device is explicit, and
the per-module modes that raised until they were ported build and evaluate
as the JAX package's.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_port_harness import SMALL, assert_energy_and_gradient_match, make_minimizer, \
    seed_host

REPO = Path(__file__).resolve().parent.parent
STEPS = 5


@pytest.mark.parametrize(
    "kw,refines", [(None, 0), (SMALL, 1)], ids=["plain-L0", "small-L1"]
)
def test_five_steps_match_jax_f64(kw, refines):
    jm = make_minimizer(False, kw=kw, refines=refines)
    tm = make_minimizer(True, kw=kw, refines=refines)
    assert tm.compute_energy() == pytest.approx(jm.compute_energy(), rel=1e-12)
    jb, tb = jm.compute_energy_breakdown(), tm.compute_energy_breakdown()
    assert sorted(tb) == sorted(jb)
    for name, val in jb.items():
        assert tb[name] == pytest.approx(val, rel=1e-12, abs=1e-14), name
    for step in range(STEPS):
        rj, rt = jm.minimize(1), tm.minimize(1)
        assert rt["energy"] == pytest.approx(rj["energy"], rel=1e-9), step
        assert rt["iterations"] == rj["iterations"] == 1
        assert rt["step_success"] == rj["step_success"]
    # the host mesh is written back after each call
    import numpy as np

    np.testing.assert_allclose(
        tm.mesh.positions_array(), jm.mesh.positions_array(), rtol=0, atol=1e-9
    )


def test_float32_run_descends_near_float64():
    energies = {}
    for dtype in (torch.float64, torch.float32):
        mn = make_minimizer(True, kw=SMALL, dtype=dtype)
        assert mn.problem().state.positions.dtype == dtype
        energies[dtype] = [mn.minimize(1)["energy"] for _ in range(3)]
    e32, e64 = energies[torch.float32], energies[torch.float64]
    assert all(map(lambda e: e == e and abs(e) < float("inf"), e32))
    assert e32[-1] < e32[0]
    for a, b in zip(e32, e64):
        assert a == pytest.approx(b, rel=2e-3)


def test_port_runs_without_jax_in_a_fresh_process():
    code = (
        "import sys, json, torch\n"
        "from membrane_solver_tpu_torch import Minimizer, parse_geometry\n"
        "from membrane_solver_tpu_torch.meshgen import build\n"
        "mesh = parse_geometry(build('kozlov_1disk', n_sectors=8, n_outer_rings=4,"
        " n_disk_rings=2))\n"
        "mesh.global_parameters.update({'tilt_solve_mode': 'coupled', 'step_size_mode':"
        " 'fixed', 'step_size': 0.005})\n"
        "mn = Minimizer(mesh, device='cpu', dtype=torch.float64, quiet=True)\n"
        "r = mn.minimize(1)\n"
        "print(json.dumps({'energy': r['energy'], 'jax': 'jax' in sys.modules,"
        " 'jax_pkg': any(m == 'membrane_solver_tpu' or m.startswith('membrane_solver_tpu.')"
        " for m in sys.modules)}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["jax"] is False and result["jax_pkg"] is False
    assert result["energy"] == result["energy"]  # finite, not NaN


def test_port_sources_import_neither_jax_nor_the_jax_package():
    pkg = REPO / "membrane_solver_tpu_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                words = stripped.replace(",", " ").split()
                assert "jax" not in words[1].split("."), f"{path}: {line}"
                assert words[1].split(".")[0] != "membrane_solver_tpu", f"{path}: {line}"


def test_cuda_device_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from membrane_solver_tpu_torch import Minimizer, parse_geometry
    from membrane_solver_tpu_torch.meshgen import build

    mesh = parse_geometry(build("kozlov_1disk", **SMALL))
    with pytest.raises(RuntimeError, match="cuda"):
        Minimizer(mesh)
    with pytest.raises(ValueError):
        Minimizer(mesh, device="cpu", dtype=torch.float16)


def _small_mesh(**gp):
    from membrane_solver_tpu_torch import parse_geometry
    from membrane_solver_tpu_torch.meshgen import build

    data = build("kozlov_1disk", **SMALL)
    data["global_parameters"].update(gp)
    return data, parse_geometry


@pytest.mark.parametrize(
    "gp,needle",
    [
        ({"tilt_thetaB_contact_work_mode": "field_linear"}, "tilt_thetaB_contact_work_mode"),
        ({"tilt_mass_mode_in": "diagonal"}, "tilt_mass_mode_in"),
        ({"bending_tilt_in_update_mode": "radial_cross_term_off_v1"},
         "bending_tilt_in_update_mode"),
        ({"bending_tilt_base_term_reference_mode": "flat_reference_zero_J0"},
         "bending_tilt_base_term_reference_mode"),
        ({"tilt_thetaB_contact_penalty_mode": "legacy"}, "tilt_thetaB_contact_penalty_mode"),
        ({"pin_to_plane_mode": "slide"}, "pin_to_plane_mode"),
        ({"bending_tilt_assume_J0_presets": ["disk"]}, "bending_tilt_assume_J0_presets"),
    ],
)
def test_unported_options_raise_when_the_problem_is_built(gp, needle):
    """Each of these values raised NotImplementedError (its key in the message) until it
    was ported; now the problem builds, and its energy and projected gradient on a seeded
    state match the JAX package's at rel 1e-12."""
    jm = make_minimizer(False, kw=SMALL, gp=gp)
    tm = make_minimizer(True, kw=SMALL, gp=gp, dtype=torch.float64)
    for mn in (jm, tm):
        seed_host(mn, 5)
    assert_energy_and_gradient_match(jm, tm, 1e-12, needle)


def test_unported_module_and_rim_flag_raise():
    from membrane_solver_tpu_torch import Minimizer

    import jax

    jax.config.update("jax_platforms", "cpu")
    import membrane_solver_tpu as jpkg
    from membrane_solver_tpu.meshgen import build

    # a module name with no module: the JAX package's error type (importlib's)
    data, parse = _small_mesh()
    data["energy_modules"] = list(data["energy_modules"]) + ["no_such_module"]
    with pytest.raises(ModuleNotFoundError, match="no_such_module"):
        Minimizer(parse(data), device="cpu", quiet=True).problem()
    jdata = build("kozlov_1disk", **SMALL)
    jdata["energy_modules"] = list(jdata["energy_modules"]) + ["no_such_module"]
    with pytest.raises(ModuleNotFoundError, match="no_such_module"):
        jpkg.Minimizer(jpkg.parse_geometry(jdata), quiet=True).problem()

    # the physical-edge rim placement (local interface shells) compiles; an
    # unknown rim mode raises the JAX package's ValueError
    data, parse = _small_mesh(rim_slope_match_mode="physical_edge_staggered_v1")
    flags = Minimizer(parse(data), device="cpu", quiet=True).problem().spec.static_of(
        "constraint:rim_slope_match_out")
    assert flags[0] == "active" and flags[6] is True
    data, parse = _small_mesh(rim_slope_match_mode="bogus")
    with pytest.raises(ValueError, match="physical_edge_staggered_v1"):
        Minimizer(parse(data), device="cpu", quiet=True).problem()


def test_per_step_report_when_not_quiet(capsys):
    from membrane_solver_tpu_torch import Minimizer

    data, parse = _small_mesh(tilt_solve_mode="coupled", step_size_mode="fixed")
    mn = Minimizer(parse(data), device="cpu")
    res = mn.minimize(2)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Step")]
    assert len(lines) == 2 and res["iterations"] == 2
