"""Local shell rows of the curved disk-boundary interface modules (host NumPy).

Counterpart of ``membrane_solver_tpu/constraints/local_interface_shells.py``:
the disk-boundary group ("disk": every vertex whose ``rim_slope_match_group``,
``tilt_thetaB_group`` or ``tilt_thetaB_group_in`` names it), the first
shell of cylindrical radius outside it ("rim"; with
``parity_trace_layer_radius`` set, the shell nearest that radius) and the
next one ("outer"), each ordered by azimuth, and the rows of one shell
matched to another's by azimuth (a cyclic roll on equal counts, the
nearest row otherwise).  Resolved once per compile from the compile-time
positions; the modules recompute radii, slopes and bases live.  No
constraint hooks: the energies and constraints of the family load it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShellRows:
    disk_rows: np.ndarray
    rim_rows: np.ndarray
    outer_rows: np.ndarray
    disk_rows_matched: np.ndarray  # aligned with rim_rows
    rim_rows_matched: np.ndarray  # aligned with outer_rows
    rim_rows_for_disk: np.ndarray  # aligned with disk_rows
    outer_rows_for_rim: np.ndarray  # aligned with rim_rows
    outer_rows_for_disk: np.ndarray  # aligned with disk_rows
    disk_radius: float
    rim_radius: float
    outer_radius: float


def _collect_disk_rows(layout, group: str) -> np.ndarray:
    mesh = layout.mesh
    rows = []
    for vid in sorted(mesh.vertices):
        opts = mesh.vertices[vid].options or {}
        if (
            opts.get("rim_slope_match_group") == group
            or opts.get("tilt_thetaB_group") == group
            or opts.get("tilt_thetaB_group_in") == group
        ):
            rows.append(layout.row_of[int(vid)])
    return np.asarray(rows, dtype=int)


def _phi(positions, rows):
    return np.mod(np.arctan2(positions[rows, 1], positions[rows, 0]), 2.0 * np.pi)


def _order_by_angle(positions, rows):
    return np.asarray(rows[np.argsort(_phi(positions, rows))], dtype=int)


def _match_by_azimuth(source_phi, target_rows, target_phi):
    """Target rows aligned with the source angles.

    Equal counts: the cyclic roll of the target rows with the least mean
    wrapped angular gap (cyclic order kept); otherwise the nearest row.
    """
    source_phi = np.asarray(source_phi, dtype=float)
    target_rows = np.asarray(target_rows, dtype=int)
    target_phi = np.asarray(target_phi, dtype=float)

    def wrapped(a, b):
        d = np.abs(a - b)
        return np.minimum(d, 2.0 * np.pi - d)

    if source_phi.size == target_rows.size and source_phi.size > 0:
        best_shift, best_cost = 0, float("inf")
        for shift in range(source_phi.size):
            cost = float(np.mean(wrapped(source_phi, np.roll(target_phi, -shift))))
            if cost < best_cost:
                best_cost, best_shift = cost, shift
        return np.asarray(np.roll(target_rows, -best_shift), dtype=int)

    diff = wrapped(source_phi[:, None], target_phi[None, :])
    return np.asarray(target_rows[np.argmin(diff, axis=1)], dtype=int)


def layout_positions(layout) -> np.ndarray:
    """(N, 3) compile-time positions in row order."""
    mesh = layout.mesh
    return np.array([mesh.vertices[int(v)].position for v in layout.vertex_ids], dtype=float)


def build_shell_rows(layout, *, group: str = "disk") -> ShellRows | None:
    """The three shells and their azimuth matchings, or None when a shell is empty."""
    mesh = layout.mesh
    n = len(layout.vertex_ids)
    positions = layout_positions(layout)
    disk_rows = _collect_disk_rows(layout, group)
    if disk_rows.size == 0:
        return None
    disk_rows = _order_by_angle(positions, disk_rows)
    radii = np.linalg.norm(positions[:, :2], axis=1)
    disk_radius = float(np.max(radii[disk_rows]))
    disk_mask = np.zeros(n, dtype=bool)
    disk_mask[disk_rows] = True

    trace_layer_radius = mesh.global_parameters.get("parity_trace_layer_radius")
    rim_candidates = (~disk_mask) & (radii > (disk_radius + 1e-9))
    if not np.any(rim_candidates):
        return None
    if trace_layer_radius is None:
        rim_radius = float(np.min(radii[rim_candidates]))
    else:
        shell_radii = np.unique(np.round(radii[rim_candidates], 12))
        shell_radii = shell_radii[shell_radii >= (disk_radius + 1e-9)]
        if shell_radii.size == 0:
            return None
        idx = int(np.argmin(np.abs(shell_radii - float(trace_layer_radius))))
        rim_radius = float(shell_radii[idx])
    rim_tol = max(1e-9, 1e-5 * max(1.0, abs(rim_radius)))
    rim_rows = _order_by_angle(
        positions, np.flatnonzero((~disk_mask) & (np.abs(radii - rim_radius) <= rim_tol))
    )
    outer_mask = (~disk_mask) & (~np.isin(np.arange(n), rim_rows))
    outer_candidates = outer_mask & (radii > (rim_radius + rim_tol))
    if not np.any(outer_candidates):
        return None
    outer_radius = float(np.min(radii[outer_candidates]))
    outer_tol = max(1e-9, 1e-5 * max(1.0, abs(outer_radius)))
    outer_rows = _order_by_angle(
        positions,
        np.flatnonzero(outer_mask & (np.abs(radii - outer_radius) <= outer_tol)),
    )

    phi_rim, phi_out, phi_disk = (_phi(positions, r) for r in (rim_rows, outer_rows, disk_rows))
    return ShellRows(
        disk_rows=disk_rows,
        rim_rows=rim_rows,
        outer_rows=outer_rows,
        disk_rows_matched=_match_by_azimuth(phi_rim, disk_rows, phi_disk),
        rim_rows_matched=_match_by_azimuth(phi_out, rim_rows, phi_rim),
        rim_rows_for_disk=_match_by_azimuth(phi_disk, rim_rows, phi_rim),
        outer_rows_for_rim=_match_by_azimuth(phi_rim, outer_rows, phi_out),
        outer_rows_for_disk=_match_by_azimuth(phi_disk, outer_rows, phi_out),
        disk_radius=disk_radius,
        rim_radius=rim_radius,
        outer_radius=outer_radius,
    )


def pack_pairs(layout, rows_a: np.ndarray, rows_b: np.ndarray) -> dict:
    """Aligned row pairs as extras: ``rows_a``, ``rows_b``, ``valid``.

    Exact sizes (the JAX package pads to a power of two); no pair compiles
    to one invalid pair on row 0.
    """
    if len(rows_a) == 0:
        return {"rows_a": np.zeros(1, dtype=np.int64), "rows_b": np.zeros(1, dtype=np.int64),
                "valid": np.zeros(1, dtype=bool)}
    return {"rows_a": np.asarray(rows_a, dtype=np.int64),
            "rows_b": np.asarray(rows_b, dtype=np.int64),
            "valid": np.ones(len(rows_a), dtype=bool)}
