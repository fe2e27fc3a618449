"""Global parameter store and per-entity parameter resolution.

Copy of ``membrane_solver_tpu/core/parameters.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``core/parameters/global_parameters.py`` and ``resolver.py``.
Defaults mirror the reference so input files behave identically.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

_DEFAULTS: Dict[str, Any] = {
    "surface_tension": 1.0,
    "volume_stiffness": 1000.0,
    # "penalty" = soft quadratic volume energy; "lagrange" = hard constraint
    # via KKT gradient projection (Evolver-like default).
    "volume_constraint_mode": "lagrange",
    "volume_projection_during_minimization": True,
    "volume_tolerance": 1e-3,
    "max_zero_steps": 10,
    "step_size_floor": 1e-8,
    "step_size": 1e-3,
    "step_size_mode": "adaptive",  # or "fixed"
    "intrinsic_curvature": 0.0,
    "bending_modulus": 0.0,
    "bending_energy_model": "helfrich",
    "bending_gradient_mode": "analytic",
    "gaussian_modulus": 0.0,
    "tilt_solver": "cg",
    "tilt_cg_preconditioner": "jacobi",
    "mesh_quality_auto_repair_enabled": True,
    "mesh_quality_auto_repair_every": 50,
    "mesh_quality_aspect_threshold": 3.0,
    "mesh_quality_aspect_percentile": 90.0,
    "mesh_quality_max_repair_passes": 1,
}


class GlobalParameters:
    """Dict-backed parameter store with attribute access and solver defaults."""

    def __init__(self, initial: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_params", dict(_DEFAULTS))
        if initial:
            self._params.update(initial)

    # -- dict-style API -------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._params.get(key, default)

    def set(self, key: str, value: Any) -> None:
        self._params[key] = value

    def update(self, params: Dict[str, Any]) -> None:
        self._params.update(params)

    def unset(self, key: str) -> None:
        self._params.pop(key, None)

    def to_dict(self) -> Dict[str, Any]:
        return self._params

    def __contains__(self, key: str) -> bool:
        return key in self._params

    def __iter__(self) -> Iterator[str]:
        return iter(self._params)

    # -- attribute-style API -------------------------------------------
    def __getattr__(self, name: str) -> Any:
        params = self.__dict__.get("_params")
        if params is not None and name in params:
            return params[name]
        raise AttributeError(f"GlobalParameters has no parameter {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "_params":
            object.__setattr__(self, name, value)
        else:
            self._params[name] = value

    def __repr__(self) -> str:
        return f"GlobalParameters({self._params})"

    def copy(self) -> "GlobalParameters":
        gp = GlobalParameters()
        gp._params = dict(self._params)
        return gp


class ParameterResolver:
    """Resolve a parameter for an entity: per-entity option, else global value."""

    def __init__(self, global_params: GlobalParameters):
        self.global_params = global_params

    def get(self, entity, name: str, default: Any = None) -> Any:
        options = getattr(entity, "options", None)
        if options and name in options:
            return options[name]
        return self.global_params.get(name, default)
