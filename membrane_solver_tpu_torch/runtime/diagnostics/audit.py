"""Debug-level audit logging for the minimization loop.

Counterpart of ``membrane_solver_tpu/runtime/diagnostics/audit.py``:
DEBUG-gated phase markers, the energy-consistency check, the Lagrange
tangency check, and the Gauss-Bonnet monitor hook (global parameter
``gauss_bonnet_monitor``).  All are report-only; none changes the solver
state.  The checks that walk the host mesh write the device state back to
it first.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

logger = logging.getLogger("membrane_solver_tpu_torch")


def log_energy_phase(iteration: int, phase: str, energy: float) -> None:
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("E[%d:%s] = %.12f", iteration, phase, energy)


def log_step_direction_stats(iteration: int, grad_arr: np.ndarray) -> None:
    if logger.isEnabledFor(logging.DEBUG):
        norms = np.linalg.norm(np.asarray(grad_arr), axis=1)
        logger.debug(
            "grad[%d]: |g|=%.3e max_row=%.3e mean_row=%.3e",
            iteration,
            float(np.linalg.norm(grad_arr)),
            float(norms.max(initial=0.0)),
            float(norms.mean()) if norms.size else 0.0,
        )


def log_energy_consistency(minimizer, label: str) -> None:
    """The energy of ``compute_energy`` against that of the energy-and-gradient path.

    One energy assembly serves both, so the check catches stale device
    state rather than two diverging pipelines.
    """
    if not logger.isEnabledFor(logging.DEBUG):
        return
    try:
        e1 = float(minimizer.compute_energy())
        e2, _ = minimizer.compute_energy_and_gradient_array()
    except Exception as exc:  # pragma: no cover - diagnostics must not raise
        logger.debug("Energy consistency check (%s) skipped: %s", label, exc)
        return
    diff = abs(e1 - float(e2))
    tol = 1e-8 * max(1.0, abs(e1), abs(e2))
    if diff > tol:
        top = sorted(
            minimizer.compute_energy_breakdown().items(),
            key=lambda kv: abs(kv[1]),
            reverse=True,
        )[:5]
        logger.warning(
            "Energy consistency mismatch (%s): |d|=%.3e (%.6f vs %.6f). Top: %s",
            label, diff, e1, float(e2),
            ", ".join(f"{k}={v:.6f}" for k, v in top),
        )
    else:
        logger.debug("Energy consistency (%s): %.6f", label, e1)


def log_lagrange_tangency_check(minimizer, grad: Dict[int, np.ndarray]) -> None:
    """DEBUG check: projected gradient tangent to fixed-volume manifolds."""
    if not logger.isEnabledFor(logging.DEBUG):
        return
    if minimizer.global_params.get("volume_constraint_mode", "lagrange") != "lagrange":
        return
    minimizer._sync_host()  # the volume gradients read the host positions
    for body in minimizer.mesh.bodies.values():
        target = body.target_volume
        if target is None:
            target = body.options.get("target_volume")
        if target is None:
            continue
        _, vol_grad = body.compute_volume_and_gradient(minimizer.mesh)
        dot = sum(
            float(np.dot(grad[v], g)) for v, g in vol_grad.items() if v in grad
        )
        logger.debug("Lagrange tangency body %s: <gradE, gradV>=%.3e", body.index, dot)


def check_gauss_bonnet(minimizer) -> None:
    """Evaluate the Gauss-Bonnet monitor when gp gauss_bonnet_monitor is on."""
    gp = minimizer.global_params
    if not bool(gp.get("gauss_bonnet_monitor", False)):
        return
    from membrane_solver_tpu_torch.runtime.diagnostics.gauss_bonnet import GaussBonnetMonitor

    monitor = getattr(minimizer, "_gauss_bonnet_monitor", None)
    if monitor is None:
        monitor = GaussBonnetMonitor.from_mesh(
            minimizer.mesh,
            eps_angle=float(gp.get("gauss_bonnet_eps_angle", 1e-4)),
            c1=float(gp.get("gauss_bonnet_c1", 1.0)),
            c2=float(gp.get("gauss_bonnet_c2", 1.0)),
        )
        minimizer._gauss_bonnet_monitor = monitor
    report = monitor.evaluate(minimizer.mesh)
    if not report["ok"]:
        logger.warning(
            "Gauss-Bonnet drift exceeded tolerance: |dG|=%.3e (tol %.3e).",
            report["drift_G"],
            report["tol_G"],
        )
