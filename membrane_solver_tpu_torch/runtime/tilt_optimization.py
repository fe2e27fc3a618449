"""Global scalar theta_B optimization by reduced-energy sampling.

Counterpart of ``membrane_solver_tpu/runtime/tilt_optimization.py``: every
``tilt_thetaB_optimize_every`` iterations, evaluate the total energy after
a short (``tilt_thetaB_optimize_inner_steps``) leaflet-tilt relaxation for
theta_B in {base, base - delta, base + delta}; keep the argmin (tilts
included), roll back when no candidate beats the base energy, and discard a
candidate whose energy spikes past the tilt relax's guard threshold.  Scan
records append to ``mesh._thetaB_scan_trace``.

The minimizer calls it between minimize blocks, after the iteration's
guarded relax and before its shape step.  Writing the new theta_B into the
global parameters changes a dynamic-only key, so the minimizer refreshes
its parameters and keeps the compiled problem.
"""

from __future__ import annotations

import dataclasses

import torch


def thetaB_scan_due(minimizer, iteration: int) -> bool:
    gp = minimizer.global_params
    mode_match = str(gp.get("rim_slope_match_mode") or "").strip().lower()
    trace_radius = gp.get("parity_trace_layer_radius")
    outer_shells = int(gp.get("parity_outer_shells", 0) or 0)
    if (
        mode_match == "physical_edge_staggered_v1"
        and trace_radius is not None
        and outer_shells > 0
    ):
        return False  # scaffold trace lanes skip the scan
    if not bool(gp.get("tilt_thetaB_optimize", False)):
        return False
    every = max(int(gp.get("tilt_thetaB_optimize_every", 10) or 10), 1)
    return int(iteration) % every == 0


def optimize_thetaB_scalar(minimizer, *, tilt_mode: str, iteration: int) -> None:
    """Coordinate-descent update of gp['tilt_thetaB_value'] (see the module docstring)."""
    from membrane_solver_tpu_torch.device.state import build_params
    from membrane_solver_tpu_torch.runtime import jit_core
    from membrane_solver_tpu_torch.runtime import tilt_relax as _tr

    gp = minimizer.global_params
    if not thetaB_scan_due(minimizer, iteration):
        return
    delta = float(gp.get("tilt_thetaB_optimize_delta", 0.02) or 0.0)
    if delta <= 0.0:
        return

    p = minimizer.problem()
    if not _tr.spec_uses_leaflet_tilts(p.spec):
        return
    relax = _tr.make_relax_leaflet_tilts(p.spec)
    energy_fn = jit_core.make_energy_value(p.spec)
    breakdown_fn = jit_core.make_energy_breakdown(p.spec)

    base_theta = float(gp.get("tilt_thetaB_value") or 0.0)
    base_state = p.state
    device, dtype = minimizer.device, minimizer.dtype
    params = build_params(minimizer.mesh, device, dtype)

    # the scan's relax budget, as the JAX package derives it: nested ->
    # the scan's own steps, coupled -> tilt_coupled_steps (fallback the
    # scan's steps), and for CG tilt_cg_max_iters overrides either
    scan_steps = max(int(gp.get("tilt_thetaB_optimize_inner_steps", 20) or 20), 1)
    if str(tilt_mode).strip().lower() != "nested":
        scan_steps = int(gp.get("tilt_coupled_steps", scan_steps) or scan_steps)
    if str(gp.get("tilt_solver", "cg") or "cg").strip().lower() == "cg":
        scan_steps = int(gp.get("tilt_cg_max_iters", scan_steps) or scan_steps)
    scan_steps = max(scan_steps, 1)
    t_step = jit_core.scalar_param(params, "tilt_step_size", 0.0)
    t_tol = jit_core.scalar_param(params, "tilt_tol", 0.0)
    guard_factor = float(gp.get("tilt_relax_energy_guard_factor", 0.0) or 0.0)
    guard_min = float(gp.get("tilt_relax_energy_guard_min", 1e-4) or 1e-4)

    # Every candidate's relax, energy and breakdown are launched before the
    # one host read of their values (the relax itself still reads its own
    # accept decisions).
    def launch_candidate(theta):
        cand_params = dict(params)
        cand_params["tilt_thetaB_value"] = torch.tensor(theta, dtype=dtype, device=device)
        st, _stats = relax(base_state, p.topo, cand_params, scan_steps, t_step, t_tol)
        return st, energy_fn(st, p.topo, cand_params), breakdown_fn(st, p.topo, cand_params)

    launched = [(base_state, energy_fn(base_state, p.topo, params),
                 breakdown_fn(base_state, p.topo, params))]
    launched += [launch_candidate(base_theta - delta), launch_candidate(base_theta + delta)]
    keys = list(launched[0][2])
    values = torch.stack([v for _st, e, bd in launched for v in (e, *bd.values())]).tolist()
    width = 1 + len(keys)
    read = [(values[i * width], dict(zip(keys, values[i * width + 1:(i + 1) * width])))
            for i in range(3)]
    (e0, bd0), (e_minus, bdm), (e_plus, bdp) = read
    st_minus, st_plus = launched[1][0], launched[2][0]

    record = {
        "iteration": int(iteration),
        "status": "evaluated",
        "base_thetaB": base_theta,
        "selected_thetaB": base_theta,
        "candidate_energies": [
            dict({"thetaB": base_theta, "energy": e0, "discarded": False}, **bd0)
        ],
    }

    def admit(theta, e, st, bd):
        """Guard + scan record (a full breakdown per candidate)."""
        discarded = guard_factor > 0.0 and e > max(guard_min, abs(e0) * guard_factor)
        record["candidate_energies"].append(
            dict({"thetaB": float(theta), "energy": e, "discarded": bool(discarded)}, **bd)
        )
        return (float("inf"), base_state) if discarded else (e, st)

    e_minus, st_minus = admit(base_theta - delta, e_minus, st_minus, bdm)
    e_plus, st_plus = admit(base_theta + delta, e_plus, st_plus, bdp)

    best_e, best_theta, best_state = min(
        [
            (e0, base_theta, base_state),
            (e_minus, base_theta - delta, st_minus),
            (e_plus, base_theta + delta, st_plus),
        ],
        key=lambda x: x[0],
    )
    if best_e > e0:
        record["status"] = "rollback"
    else:
        gp.set("tilt_thetaB_value", float(best_theta))
        record["selected_thetaB"] = float(best_theta)
        p.state = dataclasses.replace(
            base_state, tilts_in=best_state.tilts_in, tilts_out=best_state.tilts_out
        )
        p.params = build_params(minimizer.mesh, device, dtype)

    traces = getattr(minimizer.mesh, "_thetaB_scan_trace", None)
    if traces is None:
        traces = []
        setattr(minimizer.mesh, "_thetaB_scan_trace", traces)
    traces.append(record)
