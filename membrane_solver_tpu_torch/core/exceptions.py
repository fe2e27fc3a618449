"""Solver exception hierarchy.

Copy of ``membrane_solver_tpu/core/exceptions.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``core/exceptions.py``.
"""

from __future__ import annotations


class MembraneSolverError(Exception):
    """Base class for all solver errors."""


class InvalidEdgeIndexError(MembraneSolverError):
    """A facet references an edge index that does not exist (or signed 0)."""


class BodyOrientationError(MembraneSolverError):
    """A body's facet loop orientation is inconsistent or inward-facing.

    Carries the offending mesh so interactive callers can offer to repair it.
    """

    def __init__(self, message: str, mesh=None, body_index: int | None = None):
        super().__init__(message)
        self.mesh = mesh
        self.body_index = body_index
