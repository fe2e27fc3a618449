"""Multi-disk separation sweep analysis.

Counterpart of ``membrane_solver_tpu/analysis/multidisk_sweep.py`` (the
reference's ``membrane_solver/analysis/multidisk_sweep.py:53-449``): scan a
directory of converged meshes (one per disk separation L), extract
observables (total and per-module energies, disk separation, rim tilt
magnitudes, max height, area, volume, radius of gyration, min edge length)
through the port's ``Minimizer``, and write ``results.csv`` /
``results.json`` plus the energy-vs-L, interaction-energy and observables
figures (matplotlib optional).  The meshes are evaluated on the card unless
the caller asks for the CPU (``device="cpu"``, ``--cpu``); a sweep that
produces the meshes themselves runs through ``parallel.sweep``.

    python -m membrane_solver_tpu_torch.analysis.multidisk_sweep runs/ -o out/ [--cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
import re
import sys
from pathlib import Path
from typing import Dict, List

def _separation_from_name(path: Path) -> float | None:
    m = re.search(r"[LS][_=]?([0-9]+(?:\.[0-9]+)?)", path.stem)
    return float(m.group(1)) if m else None


def analyze_mesh(path: Path, *, device="cuda", dtype=None) -> Dict:
    """One row of observables of the mesh at ``path``, evaluated on ``device`` (float64 default)."""
    import numpy as np
    import torch

    from membrane_solver_tpu_torch import Minimizer, load_data, parse_geometry

    mesh = parse_geometry(load_data(str(path)))
    minim = Minimizer(mesh, quiet=True, device=device,
                      dtype=torch.float64 if dtype is None else dtype)
    p = minim.problem()
    pos = p.state.positions.detach().cpu().to(torch.float64).numpy()

    # disk centroids from tagged groups (rigid_disk_group / disk_tag / preset)
    groups: Dict[str, List[int]] = {}
    for vid, v in mesh.vertices.items():
        opts = v.options or {}
        tag = opts.get("rigid_disk_group") or opts.get("disk_tag") or (
            "disk" if str(opts.get("preset") or "") == "disk" else None
        )
        if tag:
            groups.setdefault(str(tag), []).append(vid)
    centroids = {}
    row_of = {vid: i for i, vid in enumerate(sorted(mesh.vertices))}
    for tag, vids in groups.items():
        centroids[tag] = pos[[row_of[v] for v in vids]].mean(axis=0)

    separation = None
    tags = sorted(centroids)
    if len(tags) >= 2:
        a, b = centroids[tags[0]], centroids[tags[1]]
        separation = float(np.linalg.norm(a - b))
    if separation is None:
        separation = _separation_from_name(path)

    breakdown = {k: float(v) for k, v in minim.compute_energy_breakdown().items()}
    tin = p.state.tilts_in.detach().cpu().to(torch.float64).numpy()
    tout = p.state.tilts_out.detach().cpu().to(torch.float64).numpy()
    # shape observables (reference multidisk_sweep.py:9 — area, volume,
    # surface radius of gyration, min edge length)
    area = float(mesh.compute_total_surface_area())
    volume = float(sum(mesh.body_volume(b) for b in mesh.bodies.values()) or 0.0)
    centroid = pos.mean(axis=0)
    rg = float(np.sqrt(np.mean(np.sum((pos - centroid) ** 2, axis=1))))
    edge_rows = np.asarray(
        [
            [row_of[e.tail_index], row_of[e.head_index]]
            for e in mesh.edges.values()
            if e.tail_index in row_of and e.head_index in row_of
        ],
        dtype=int,
    )
    min_edge = (
        float(np.linalg.norm(pos[edge_rows[:, 0]] - pos[edge_rows[:, 1]], axis=1).min())
        if len(edge_rows)
        else 0.0
    )
    return {
        "file": path.name,
        "separation": separation,
        "energy": float(minim.compute_energy()),
        "max_height": float(np.abs(pos[:, 2]).max()),
        "area": area,
        "volume": volume,
        "radius_of_gyration": rg,
        "min_edge_length": min_edge,
        "rim_tilt_in_max": float(np.linalg.norm(tin, axis=1).max()),
        "rim_tilt_out_max": float(np.linalg.norm(tout, axis=1).max()),
        **{f"E_{k}": v for k, v in breakdown.items()},
    }


def run_sweep(mesh_dir: Path, out_dir: Path, plot: bool = True, *, device="cuda",
              dtype=None) -> List[Dict]:
    """Analyze every mesh file of ``mesh_dir``, sorted by separation; write the outputs.

    A file that fails to load or evaluate is reported on stderr and
    skipped.  ``device`` must exist (a missing card raises before the scan).
    """
    from membrane_solver_tpu_torch.runtime.minimizer import resolve_device

    resolve_device(device)
    rows = []
    paths = sorted(
        [p for p in mesh_dir.iterdir() if p.suffix in {".json", ".yaml", ".yml"}]
    )
    for path in paths:
        try:
            rows.append(analyze_mesh(path, device=device, dtype=dtype))
        except Exception as exc:  # noqa: BLE001 — report and continue the scan
            print(f"skip {path.name}: {type(exc).__name__}: {exc}", file=sys.stderr)
    rows.sort(key=lambda r: (r["separation"] is None, r["separation"]))

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "results.json").write_text(json.dumps(rows, indent=1) + "\n")
    if rows:
        with open(out_dir / "results.csv", "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=sorted({k for r in rows for k in r}))
            writer.writeheader()
            writer.writerows(rows)

    if plot and len(rows) >= 2 and all(r["separation"] is not None for r in rows):
        _plot(rows, out_dir)
    return rows


def _plot(rows: List[Dict], out_dir: Path) -> None:
    import numpy as np

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # matplotlib optional
        return
    L = [r["separation"] for r in rows]
    E = [r["energy"] for r in rows]
    e_inf = E[-1]  # largest separation approximates isolated disks

    # energy_vs_L.png (reference multidisk_sweep.py:414)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(L, E, "o-")
    ax.set_xlabel("separation L")
    ax.set_ylabel("total energy")
    ax.set_title("Energy vs separation")
    fig.tight_layout()
    fig.savefig(out_dir / "energy_vs_L.png", dpi=130)
    plt.close(fig)

    # interaction_energy_vs_L.png (reference :425)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(L, [e - e_inf for e in E], "o-")
    ax.axhline(0.0, color="0.6", lw=0.8)
    ax.set_xlabel("separation L")
    ax.set_ylabel("interaction energy E(L) − E(∞)")
    ax.set_title("Disk–disk interaction energy")
    fig.tight_layout()
    fig.savefig(out_dir / "interaction_energy_vs_L.png", dpi=130)
    plt.close(fig)

    # observables_vs_L.png (reference :441 — shape observables panel)
    obs_keys = [
        ("area", "area"),
        ("volume", "volume"),
        ("radius_of_gyration", "R_g"),
        ("min_edge_length", "min edge"),
        ("max_height", "max |z|"),
        ("rim_tilt_in_max", "max |t_in|"),
    ]
    avail = [(k, lbl) for k, lbl in obs_keys if any(k in r for r in rows)]
    if avail:
        fig, axes = plt.subplots(
            2, (len(avail) + 1) // 2, figsize=(4 * ((len(avail) + 1) // 2), 7)
        )
        for axo, (k, lbl) in zip(np.ravel(axes), avail):
            axo.plot(L, [r.get(k, float("nan")) for r in rows], "o-")
            axo.set_xlabel("separation L")
            axo.set_ylabel(lbl)
        for axo in np.ravel(axes)[len(avail):]:
            axo.set_axis_off()
        fig.suptitle("Shape observables vs separation")
        fig.tight_layout()
        fig.savefig(out_dir / "observables_vs_L.png", dpi=130)
        plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mesh_dir", type=Path)
    ap.add_argument("-o", "--out", type=Path, default=Path("sweep_out"))
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--f32", action="store_true", help="float32 compute (float64 otherwise)")
    args = ap.parse_args(argv)

    import torch

    rows = run_sweep(args.mesh_dir, args.out, plot=not args.no_plot,
                     device="cpu" if args.cpu else "cuda",
                     dtype=torch.float32 if args.f32 else torch.float64)
    for r in rows:
        sep = "None" if r["separation"] is None else f"{r['separation']:.4g}"
        print(f"{r['file']:40s} L={sep:>8s}  E={r['energy']:.10g}")
    return 0 if rows else 1


if __name__ == "__main__":
    raise SystemExit(main())
