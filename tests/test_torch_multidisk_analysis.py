"""The port's multi-disk sweep analysis against the JAX package's.

Mirrors ``tests/test_multidisk_analysis.py`` (three cube meshes of
growing size, the filename separation, the centroid separation of two
tagged groups, an unreadable file skipped) with
``membrane_solver_tpu_torch.analysis.multidisk_sweep`` on the CPU, and
holds its rows against the JAX package's key by key: the energies and
the per-module ``E_*`` terms at rel 1e-12, every other observable too.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import pytest
import torch

from membrane_solver_tpu.analysis import multidisk_sweep as jax_sweep
from membrane_solver_tpu.meshgen import build
from membrane_solver_tpu_torch.analysis import multidisk_sweep as port_sweep

REL = 1e-12
FIGURES = ("energy_vs_L.png", "interaction_energy_vs_L.png", "observables_vs_L.png")


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("multidisk_runs")
    for L in (2.0, 3.0, 4.5):
        data = build("cube", size=1.0 + 0.1 * L)
        (d / f"run_L{L}.json").write_text(json.dumps(data))
    return d


@pytest.fixture(scope="module")
def both_rows(sweep_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("multidisk_out")
    port = port_sweep.run_sweep(sweep_dir, out / "port", plot=True, device="cpu")
    jax = jax_sweep.run_sweep(sweep_dir, out / "jax", plot=False)
    return port, jax, out / "port"


def assert_rows_match(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float):
            assert abs(g - w) <= REL * max(abs(w), 1e-300), f"{key}: {g!r} vs {w!r}"
        else:
            assert g == w, key


def test_rows_match_jax_key_by_key(both_rows):
    port, jax, _out = both_rows
    assert [r["file"] for r in port] == [r["file"] for r in jax]
    assert [r["separation"] for r in port] == [2.0, 3.0, 4.5]
    for got, want in zip(port, jax):
        assert any(k.startswith("E_") for k in want)
        assert_rows_match(got, want)


def test_outputs_written(both_rows):
    port, _jax, out = both_rows
    for r in port:
        assert r["energy"] > 0.0 and r["area"] > 0.0 and r["volume"] > 0.0
        assert r["min_edge_length"] > 0.0 and r["radius_of_gyration"] > 0.0
    recorded = json.loads((out / "results.json").read_text())
    assert recorded == port
    with open(out / "results.csv") as fh:
        csv_rows = list(csv.DictReader(fh))
    assert len(csv_rows) == 3
    assert [float(r["energy"]) for r in csv_rows] == [r["energy"] for r in port]
    assert list(csv_rows[0]) == sorted({k for r in port for k in r})


@pytest.mark.parametrize("figure", FIGURES)
def test_figures_written(both_rows, figure):
    pytest.importorskip("matplotlib")
    assert (both_rows[2] / figure).stat().st_size > 0


def test_analyze_mesh_centroid_separation(tmp_path):
    """Two tagged rigid-disk groups -> separation = centroid distance, as in JAX."""
    data = build("cube", size=1.0)
    data["vertices"] = [list(v[:3]) + [{"rigid_disk_group": "a" if v[0] < 0.5 else "b"}]
                        for v in data["vertices"]]
    path = tmp_path / "pair.json"
    path.write_text(json.dumps(data))
    row = port_sweep.analyze_mesh(path, device="cpu")
    assert row["separation"] == pytest.approx(1.0, abs=1e-12)
    assert_rows_match(row, jax_sweep.analyze_mesh(path))


def test_float32_rows_near_float64(sweep_dir, tmp_path):
    rows32 = port_sweep.run_sweep(sweep_dir, tmp_path / "f32", plot=False, device="cpu",
                                  dtype=torch.float32)
    rows64 = json.loads((tmp_path / "f32" / "results.json").read_text())
    assert rows32 == rows64
    want = port_sweep.run_sweep(sweep_dir, tmp_path / "f64", plot=False, device="cpu")
    for got, w in zip(rows32, want):
        assert abs(got["energy"] - w["energy"]) <= 1e-5 * abs(w["energy"])


def test_skips_unreadable_files(tmp_path):
    bad = tmp_path / "mix"
    bad.mkdir()
    (bad / "run_L1.0.json").write_text(json.dumps(build("cube")))
    (bad / "broken_L9.json").write_text("{not json")
    rows = port_sweep.run_sweep(bad, tmp_path / "o", plot=False, device="cpu")
    assert [r["file"] for r in rows] == ["run_L1.0.json"]


def test_main_cpu(sweep_dir, tmp_path, capsys):
    assert port_sweep.main([str(sweep_dir), "-o", str(tmp_path / "m"), "--no-plot",
                            "--cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == ["run_L2.0.json", "run_L3.0.json", "run_L4.5.json"]
    assert not any((tmp_path / "m" / f).exists() for f in FIGURES)


def test_card_by_default_raises_without_one(sweep_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        port_sweep.run_sweep(sweep_dir, tmp_path / "c", plot=False)
    assert not (tmp_path / "c").exists()
