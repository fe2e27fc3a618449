"""The Helfrich vesicle lane end to end: the port's Minimizer against the JAX package.

The fixture's protocol (``helfrich_cube_L5_f64_jax.json``: meshgen cube,
surface + Helfrich bending, hard volume constraint in lagrange mode with
per-trial projection, adaptive step) with two triangle refines instead of
five (194 vertices), five calls of ``minimize(1)``: energies, accept
decisions, step sizes and final positions at float64 to rel 1e-10.  The
adaptive step grows after first-trial accepts and shrinks after the fourth
step's backtracking, so both sides of the adaptive branch run.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from _torch_port_harness import VESICLE_PROTOCOL, make_vesicle_minimizer

REFINES = 2
RTOL = 1e-10


@pytest.fixture(scope="module")
def runs():
    jm = make_vesicle_minimizer(False, REFINES)
    tm = make_vesicle_minimizer(True, REFINES)
    out = {"jax": [], "port": []}
    out["before"] = (jm.compute_energy(), tm.compute_energy(),
                     jm.compute_energy_breakdown(), tm.compute_energy_breakdown())
    out["sizes"] = (len(jm.mesh.vertices), len(tm.mesh.vertices), tm.problem().n_tris)
    for _ in range(VESICLE_PROTOCOL["steps"]):
        for key, mn in (("jax", jm), ("port", tm)):
            res = mn.minimize(1)
            out[key].append((res["energy"], res["step_success"], mn.step_size))
    out["positions"] = (jm.mesh.positions_array(), tm.mesh.positions_array())
    return out


def test_protocol_size_and_start(runs):
    nv_j, nv_t, nf = runs["sizes"]
    assert nv_j == nv_t == 194 and nf == 384
    ej, et, bj, bt = runs["before"]
    assert et == pytest.approx(ej, rel=1e-12)
    assert sorted(bt) == sorted(bj) == ["bending", "surface"]
    for name, val in bj.items():
        assert bt[name] == pytest.approx(val, rel=1e-12), name


@pytest.mark.parametrize("step", range(VESICLE_PROTOCOL["steps"]))
def test_step_matches_jax_f64(runs, step):
    (ej, okj, sj), (et, okt, st) = runs["jax"][step], runs["port"][step]
    assert et == pytest.approx(ej, rel=RTOL)
    assert okt == okj
    assert st == pytest.approx(sj, rel=RTOL)


def test_trajectory_descends_and_the_step_adapts_both_ways(runs):
    energies = [e for e, _ok, _s in runs["port"]]
    steps = [VESICLE_PROTOCOL["step_size"]] + [s for _e, _ok, s in runs["port"]]
    assert all(b < a for a, b in zip([runs["before"][1]] + energies, energies))
    ratios = [b / a for a, b in zip(steps, steps[1:])]
    assert max(ratios) == pytest.approx(1.5) and min(ratios) < 1.0
    pj, pt = runs["positions"]
    np.testing.assert_allclose(pt, pj, rtol=0, atol=RTOL * np.max(np.abs(pj)))


def test_float32_run_stays_near_float64():
    energies = {}
    for dtype in (torch.float64, torch.float32):
        mn = make_vesicle_minimizer(True, 1, dtype=dtype)
        assert mn.problem().state.positions.dtype == dtype
        energies[dtype] = [mn.minimize(1)["energy"] for _ in range(3)]
    e32, e64 = energies[torch.float32], energies[torch.float64]
    assert all(np.isfinite(e32))
    for a, b in zip(e32, e64):
        assert a == pytest.approx(b, rel=2e-3)
