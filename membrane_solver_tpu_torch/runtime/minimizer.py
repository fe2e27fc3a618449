"""Host orchestration of the minimization loop.

Counterpart of ``membrane_solver_tpu/runtime/minimizer.py``: mesh
compilation with the dynamic-only parameter refresh, chunk scheduling,
constraint enforcement after mesh operations, the stepper state across
``minimize`` calls, the theta_B scan (relax -> scan -> step), the
mesh-quality auto-repair cadence, and result bookkeeping.  The device and
dtype are explicit constructor arguments.  Not ported: latency-aware
placement and the AOT cache (JAX-only), the host-side scalar-parameter
hook of the legacy theta_B contact penalty (its mode raises when the
problem is compiled), the Gauss-Bonnet monitor and the DEBUG tangency
check of ``compute_energy_and_gradient``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import torch

from membrane_solver_tpu_torch.core.parameters import GlobalParameters
from membrane_solver_tpu_torch.device.state import (
    CompiledProblem,
    build_params,
    compile_state,
    writeback,
)
from membrane_solver_tpu_torch.geometry.mesh import Mesh
from membrane_solver_tpu_torch.runtime import jit_core
from membrane_solver_tpu_torch.runtime import tilt_relax as _tr
from membrane_solver_tpu_torch.runtime.steppers import BaseStepper, GradientDescent

logger = logging.getLogger("membrane_solver_tpu_torch")


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


class Minimizer:
    def __init__(
        self,
        mesh: Mesh,
        global_params: Optional[GlobalParameters] = None,
        stepper: Optional[BaseStepper] = None,
        energy_modules=None,
        constraint_modules=None,
        step_size: float = 1e-3,
        tol: float = 1e-6,
        quiet: bool = False,
        device="cuda",
        dtype: torch.dtype = torch.float64,
    ):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.mesh = mesh
        self.global_params = global_params if global_params is not None else mesh.global_parameters
        self.stepper = stepper if stepper is not None else GradientDescent()
        self.step_size = float(step_size)
        self.tol = float(tol)
        self.quiet = quiet
        self.energy_module_names = list(
            energy_modules if energy_modules is not None else mesh.energy_modules
        )
        self.constraint_module_names = list(
            constraint_modules if constraint_modules is not None else mesh.constraint_modules
        )
        self._problem: Optional[CompiledProblem] = None
        # CG/BFGS history; lives across minimize calls until invalidate()
        self._stepper_state: Optional[jit_core.StepperState] = None
        self._params_fingerprint = None
        self._mesh_token = None
        self._validated_topology_token = None

    # ------------------------------------------------------------------
    # compilation plumbing
    # ------------------------------------------------------------------
    @property
    def max_zero_steps(self) -> int:
        return int(self.global_params.get("max_zero_steps", 10))

    @property
    def step_size_floor(self) -> float:
        return float(self.global_params.get("step_size_floor", 1e-8))

    def invalidate(self) -> None:
        """Force recompilation of the device tensors from the host mesh."""
        self._problem = None
        self._stepper_state = None

    def set_mesh(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.invalidate()

    def _fresh_stepper_state(self, p: CompiledProblem) -> jit_core.StepperState:
        return jit_core.fresh_stepper_state(
            p.n_vertices, self.stepper.name, dtype=self.dtype, device=self.device
        )

    def reset_soa_caches(self) -> None:  # the reference's name
        self.invalidate()

    # Global parameters read only as dynamic parameters (build_params), never
    # by a compile hook or the spec: a change of these refreshes
    # ``problem.params`` and keeps the compiled problem and the stepper
    # history.  The theta_B scan writes tilt_thetaB_value every scan.
    _DYNAMIC_ONLY_GP_KEYS = frozenset({"tilt_thetaB_value"})

    def _fingerprint_params(self):
        gp = self.global_params.to_dict()
        return tuple(sorted((k, repr(v)) for k, v in gp.items()))

    def _only_dynamic_keys_changed(self, fp) -> bool:
        """True when the fingerprints differ in dynamic-only keys alone."""
        old, new = dict(self._params_fingerprint), dict(fp)
        changed = {k for k in old.keys() | new.keys() if old.get(k) != new.get(k)}
        return bool(changed) and changed <= self._DYNAMIC_ONLY_GP_KEYS

    def problem(self) -> CompiledProblem:
        """The compiled problem, rebuilt when the mesh or the parameters changed.

        A change of dynamic-only parameters alone refreshes the parameters
        in place.  Building the spec raises NotImplementedError for any
        module, static option or rim-matching flag outside the ported lane.
        """
        fp = self._fingerprint_params()
        # a host mesh swapped or mutated in place makes the device state
        # stale: drop it without writeback (the host is the source of truth)
        mesh_token = (self.mesh, getattr(self.mesh, "_version", 0))
        if self._problem is not None and mesh_token != self._mesh_token:
            self._problem = None
        self._mesh_token = mesh_token
        if self._problem is None or fp != self._params_fingerprint:
            if (
                self._problem is not None
                and self._params_fingerprint is not None
                and self._only_dynamic_keys_changed(fp)
            ):
                self._problem.params = build_params(self.mesh, self.device, self.dtype)
                self._params_fingerprint = fp
                return self._problem
            if self._problem is not None:
                writeback(self._problem, self.mesh)  # keep device-evolved state
            self._problem = compile_state(
                self.mesh, self.device, self.dtype,
                energy_modules=self.energy_module_names,
                constraint_modules=self.constraint_module_names,
            )
            self._params_fingerprint = fp
            self._stepper_state = self._fresh_stepper_state(self._problem)
        return self._problem

    def _sync_host(self) -> None:
        if self._problem is not None:
            writeback(self._problem, self.mesh)

    def _project_tilts_device(self, p: CompiledProblem):
        """Tangent-project every tilt field on the device; the identity without tilt modules."""
        if not (_tr.spec_uses_leaflet_tilts(p.spec) or _tr.spec_uses_vertex_tilts(p.spec)):
            return p.state
        return jit_core.project_all_tilts(p.state, p.topo)

    # ------------------------------------------------------------------
    # energy entry points
    # ------------------------------------------------------------------
    def compute_energy(self) -> float:
        p = self.problem()
        p.params = build_params(self.mesh, self.device, self.dtype)
        return float(jit_core.make_energy_value(p.spec)(p.state, p.topo, p.params))

    def compute_energy_and_gradient_array(self):
        """(energy, projected shape gradient (Nv, 3) as numpy), as the block assembles them."""
        p = self.problem()
        p.params = build_params(self.mesh, self.device, self.dtype)
        E, g = jit_core.make_energy_and_grad(p.spec)(p.state, p.topo, p.params)
        return float(E), g.detach().cpu().numpy()

    def compute_energy_and_gradient(self):
        """(energy, {vertex id: gradient row})."""
        E, g = self.compute_energy_and_gradient_array()
        p = self.problem()
        return E, {int(vid): g[i] for i, vid in enumerate(p.vertex_ids)}

    def compute_energy_breakdown(self) -> Dict[str, float]:
        p = self.problem()
        p.params = build_params(self.mesh, self.device, self.dtype)
        vals = jit_core.make_energy_breakdown(p.spec)(p.state, p.topo, p.params)
        return {k: float(v) for k, v in vals.items()}

    def tilt_relaxation_stats(self, max_iters: int | None = None) -> Dict[str, float]:
        """Run one inner leaflet relaxation from the current state (not committed)."""
        p = self.problem()
        p.params = build_params(self.mesh, self.device, self.dtype)
        if not _tr.spec_uses_leaflet_tilts(p.spec):
            return {"active": 0.0}
        gp = self.global_params
        iters = int(
            max_iters
            if max_iters is not None
            else gp.get("tilt_cg_max_iters", gp.get("tilt_inner_steps", 40)) or 40
        )
        step = float(gp.get("tilt_step_size", 0.1) or 0.1)
        tol = float(gp.get("tilt_tol", 0.0) or 0.0)
        _state, stats = _tr.make_relax_leaflet_tilts(p.spec)(
            p.state, p.topo, p.params, iters, step, tol
        )
        return {
            "active": 1.0,
            "accepted_steps": float(stats.accepted_steps),
            "rejected": float(stats.rejected),
            "initial_energy": stats.initial_energy,
            "final_energy": stats.final_energy,
            "final_gradient_norm": stats.final_gradient_norm,
            "max_iters": float(iters),
            "tilt_step_size": step,
        }

    def relax_leaflet_tilts(
        self,
        max_iters: int | None = None,
        step_size: float | None = None,
        tol: float | None = None,
    ) -> Dict[str, float]:
        """Run one inner leaflet tilt relaxation and commit the state (positions frozen)."""
        p = self.problem()
        p.params = build_params(self.mesh, self.device, self.dtype)
        if not _tr.spec_uses_leaflet_tilts(p.spec):
            return {"active": 0.0}
        gp = self.global_params
        iters = int(
            max_iters
            if max_iters is not None
            else gp.get("tilt_cg_max_iters", gp.get("tilt_inner_steps", 40)) or 40
        )
        step = float(step_size if step_size is not None else gp.get("tilt_step_size", 0.1) or 0.1)
        tol_v = float(tol if tol is not None else gp.get("tilt_tol", 0.0) or 0.0)
        p.state, stats = _tr.make_relax_leaflet_tilts(p.spec)(
            p.state, p.topo, p.params, iters, step, tol_v
        )
        return {
            "active": 1.0,
            "accepted_steps": float(stats.accepted_steps),
            "final_energy": stats.final_energy,
            "final_gradient_norm": stats.final_gradient_norm,
        }

    # ------------------------------------------------------------------
    # constraint enforcement
    # ------------------------------------------------------------------
    def _has_enforceable_constraints(self) -> bool:
        from membrane_solver_tpu_torch.constraints import get_constraint

        return any(
            hasattr(m, "enforce") or hasattr(m, "make_enforce")
            for m in map(get_constraint, self.constraint_module_names)
        )

    def enforce_constraints_after_mesh_ops(self, mesh: Mesh | None = None) -> None:
        """Hard geometric projection after topology surgery."""
        if mesh is not None and mesh is not self.mesh:
            self.mesh = mesh
            self.invalidate()
        if not self._has_enforceable_constraints():
            return
        p = self.problem()
        enforce = jit_core.make_constraint_enforcer(p.spec)
        if enforce is not None:
            p.state = enforce(p.state, p.topo, p.params, context="mesh_operation")
            # position-dependent compiled payloads (ring memberships, ring
            # order) must see the projected geometry: sync and recompile
            self._sync_host()
            self.invalidate()
            p = self.problem()
        p.state = _tr.make_tilt_enforcer(p.spec)(p.state, p.topo, p.params)
        p.state = self._project_tilts_device(p)
        self._sync_host()

    def _enforce_constraints(self) -> None:
        if not self._has_enforceable_constraints():
            return
        p = self.problem()
        enforce = jit_core.make_constraint_enforcer(p.spec)
        if enforce is not None:
            p.state = enforce(p.state, p.topo, p.params, context="minimize")

    # ------------------------------------------------------------------
    # the outer loop
    # ------------------------------------------------------------------
    def _check_ported_run(self) -> None:
        gp = self.global_params
        if bool(gp.get("gauss_bonnet_monitor", False)):
            raise NotImplementedError(
                "gauss_bonnet_monitor is not ported to membrane_solver_tpu_torch"
            )
        if "gaussian_curvature" in self.energy_module_names:
            for key in ("gaussian_curvature_check_defects", "gaussian_curvature_strict_topology"):
                if bool(gp.get(key, False)):
                    raise NotImplementedError(
                        f"{key} (the Gauss-Bonnet topology validation) is not ported to "
                        "membrane_solver_tpu_torch"
                    )
        raw_interval = gp.get("tilt_projection_interval")
        if raw_interval is not None and int(raw_interval) < 1:
            raise ValueError("tilt_projection_interval must be >= 1.")

    def _validate_topology(self) -> None:
        from membrane_solver_tpu_torch.runtime.validation import (
            validate_disk_interface_topology,
            validate_leaflet_absence_topology,
        )

        gp_tok = tuple(
            (k, repr(self.global_params.get(k)))
            for k in sorted(self.global_params.to_dict())
            if "leaflet" in k or "disk" in k or "interface" in k
        )
        tok = (self.mesh, getattr(self.mesh, "_topology_version", 0), gp_tok)
        if self._validated_topology_token != tok:
            validate_leaflet_absence_topology(self.mesh, self.global_params)
            validate_disk_interface_topology(self.mesh, self.global_params)
            self._validated_topology_token = tok

    def minimize(
        self, n_steps: int = 1, callback: Optional[Callable[[Mesh, int], None]] = None
    ) -> dict:
        self._check_ported_run()
        self._validate_topology()
        p = self.problem()
        p.params = build_params(self.mesh, self.device, self.dtype)
        if n_steps <= 0:
            # evaluate, enforce, return
            _E, grad = self.compute_energy_and_gradient()
            self._enforce_constraints()
            self._sync_host()
            return {
                "energy": float(self.compute_energy()),
                "gradient": grad,
                "mesh": self.mesh,
                "step_success": True,
                "iterations": 0,
                "terminated_early": True,
            }
        has_enforceable = self._has_enforceable_constraints()
        if has_enforceable:
            self.enforce_constraints_after_mesh_ops()
            p = self.problem()

        gp = self.global_params
        mode = str(gp.get("volume_constraint_mode", "lagrange"))
        proj_flag = bool(gp.get("volume_projection_during_minimization", True))
        has_volume_targets = any(
            (b.target_volume if b.target_volume is not None else b.options.get("target_volume"))
            is not None
            for b in self.mesh.bodies.values()
        )
        options = jit_core.MinimizeOptions(
            stepper=self.stepper.name,
            step_size_mode=str(gp.get("step_size_mode", "adaptive") or "adaptive").lower(),
            enforce_in_line_search=has_enforceable,
            volume_drift_check=(
                mode == "lagrange"
                and not proj_flag
                and has_volume_targets
                and "volume" in self.constraint_module_names
            ),
        )
        block = jit_core.minimize_block(p.spec, options)
        if self._stepper_state is None:
            self._stepper_state = self._fresh_stepper_state(p)
        repair_every = int(gp.get("mesh_quality_auto_repair_every", 0) or 0)
        repair_enabled = bool(gp.get("mesh_quality_auto_repair_enabled", False))
        fixed_step = float(gp.get("step_size", self.step_size) or self.step_size)

        zero_step_counter = 0
        iterations_done = 0
        step_success = True
        last_grad = None
        terminated = False
        trials = accepted = fallbacks = 0
        while iterations_done < n_steps and not terminated:
            if callback is not None:
                self._sync_host()
                callback(self.mesh, iterations_done)
            if repair_enabled and repair_every > 0:
                until_repair = repair_every - (iterations_done % repair_every)
            else:
                until_repair = n_steps
            chunk = min(n_steps - iterations_done, until_repair)
            if not self.quiet:
                chunk = 1  # per-step reporting
            tilt_mode = str(gp.get("tilt_solve_mode", "fixed") or "fixed")
            if tilt_mode == "nested":
                inner = int(gp.get("tilt_inner_steps", 0) or 0)
            else:
                inner = int(gp.get("tilt_coupled_steps", gp.get("tilt_inner_steps", 0)) or 0)
            if str(gp.get("tilt_solver", "cg") or "cg").lower() == "cg":
                inner = int(gp.get("tilt_cg_max_iters", inner) or inner)
            # the theta_B scan at its cadence: this iteration's guarded relax
            # runs here, then the scan probes candidates from the relaxed
            # tilts, and the block skips its first relax (relax -> scan -> step)
            skip_first_relax = 0
            if bool(gp.get("tilt_thetaB_optimize", False)):
                from membrane_solver_tpu_torch.runtime import tilt_optimization as _topt

                if (
                    _topt.thetaB_scan_due(self, iterations_done)
                    and _tr.spec_uses_leaflet_tilts(p.spec)
                    and tilt_mode in {"nested", "coupled"}
                ):
                    p.params = build_params(self.mesh, self.device, self.dtype)
                    p.state = jit_core.make_guarded_relax(p.spec)(p.state, p.topo, p.params, inner)
                    skip_first_relax = 1
                _topt.optimize_thetaB_scalar(self, tilt_mode=tilt_mode, iteration=iterations_done)
                p = self.problem()
                p.params = build_params(self.mesh, self.device, self.dtype)
                every = max(int(gp.get("tilt_thetaB_optimize_every", 10) or 10), 1)
                chunk = min(chunk, every - (iterations_done % every))
            step_size_used = self.step_size
            p.state, self._stepper_state, stats = block(
                p.state, p.topo, p.params, self._stepper_state, chunk, self.step_size,
                fixed_step, self.tol, self.step_size_floor, self.max_zero_steps,
                zero_step_counter, inner, skip_first_relax,
            )
            iterations_done += stats.iterations
            trials += stats.trials
            accepted += stats.accepted_steps
            fallbacks += stats.trace_z_fallbacks
            self.step_size = stats.step_size
            zero_step_counter = stats.zero_step_counter
            step_success = stats.step_success
            last_grad = stats.grad_norm
            terminated = stats.converged or stats.terminated_early
            if not self.quiet:
                self._sync_host()
                area = self.mesh.compute_total_surface_area()
                print(
                    f"Step {iterations_done - 1:4d}: Area = {area:.5f}, "
                    f"Energy = {self.compute_energy():.5f}, Step Size  = {step_size_used:.2e}"
                )
            if stats.converged:
                logger.info("Converged in %d iterations; |gradE|=%.3e", iterations_done, last_grad)
            elif stats.terminated_early:
                logger.info(
                    "Terminating early after %d consecutive zero-steps with step size <= %.2e.",
                    zero_step_counter,
                    self.step_size_floor,
                )
            # auto mesh-quality repair at the cadence boundary (host-side
            # equiangulation, runtime/quality.py); a repair replaces the mesh,
            # so the problem and the block are rebuilt
            elif (
                repair_enabled
                and repair_every > 0
                and iterations_done < n_steps
                and iterations_done % repair_every == 0
            ):
                from membrane_solver_tpu_torch.runtime.quality import (
                    maybe_auto_mesh_quality_repair,
                )

                if maybe_auto_mesh_quality_repair(self):
                    p = self.problem()
                    block = jit_core.minimize_block(p.spec, options)

        if has_enforceable:
            enforce = jit_core.make_constraint_enforcer(p.spec)
            if enforce is not None:
                p.state = enforce(p.state, p.topo, p.params, context="finalize")
        p.state = self._project_tilts_device(p)
        self._sync_host()
        return {
            "energy": float(self.compute_energy()),
            "gradient": last_grad,
            "mesh": self.mesh,
            "step_success": step_success,
            "iterations": iterations_done,
            "terminated_early": terminated,
            "line_search_trials": trials,
            "accepted_steps": accepted,
            "trace_z_fallbacks": fallbacks,
        }
