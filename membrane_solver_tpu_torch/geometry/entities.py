"""Host-side mesh entities.

Copy of ``membrane_solver_tpu/geometry/entities.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``geometry/{vertex,edge,facet,body}.py``.  These are light
bookkeeping records: per-step numerics run on dense device arrays compiled by
:mod:`membrane_solver_tpu_torch.device.state`, so entities carry no caches and no
mesh back-references (the reference's version-counter/cache machinery is
replaced by functional purity on device).

Conventions (same as the reference):
- Edges are directed ``tail -> head``; a *signed* edge index ``-k`` in a facet
  loop means edge ``k`` traversed head -> tail.  Signed index 0 is invalid.
- Facets store an ordered signed-edge loop; the implied vertex loop is the
  sequence of signed tails.
- Bodies reference facet ids and may carry a target volume.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


def _vec3(value, default: float = 0.0) -> np.ndarray:
    if value is None:
        return np.full(3, default, dtype=float)
    arr = np.asarray(value, dtype=float)
    if arr.shape == (2,):
        arr = np.array([arr[0], arr[1], 0.0], dtype=float)
    if arr.shape != (3,):
        raise ValueError(f"expected a 2- or 3-vector, got shape {arr.shape}")
    return arr


@dataclass
class Vertex:
    index: int
    position: np.ndarray
    fixed: bool = False
    options: Dict[str, Any] = field(default_factory=dict)
    tilt: np.ndarray = field(default_factory=lambda: np.zeros(3))
    tilt_in: np.ndarray = field(default_factory=lambda: np.zeros(3))
    tilt_out: np.ndarray = field(default_factory=lambda: np.zeros(3))
    tilt_fixed: bool = False
    tilt_fixed_in: bool = False
    tilt_fixed_out: bool = False

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=float).reshape(3)
        self.tilt = _vec3(self.tilt)
        self.tilt_in = _vec3(self.tilt_in)
        self.tilt_out = _vec3(self.tilt_out)

    def copy(self) -> "Vertex":
        return Vertex(
            index=self.index,
            position=self.position.copy(),
            fixed=self.fixed,
            options=dict(self.options),
            tilt=self.tilt.copy(),
            tilt_in=self.tilt_in.copy(),
            tilt_out=self.tilt_out.copy(),
            tilt_fixed=self.tilt_fixed,
            tilt_fixed_in=self.tilt_fixed_in,
            tilt_fixed_out=self.tilt_fixed_out,
        )


@dataclass
class Edge:
    index: int
    tail_index: int
    head_index: int
    fixed: bool = False
    options: Dict[str, Any] = field(default_factory=dict)

    def endpoints(self, signed_index: int) -> tuple[int, int]:
        """(tail, head) for this edge traversed with the sign of ``signed_index``."""
        if signed_index >= 0:
            return self.tail_index, self.head_index
        return self.head_index, self.tail_index

    def other(self, vertex_index: int) -> int:
        return self.head_index if self.tail_index == vertex_index else self.tail_index

    def copy(self) -> "Edge":
        return Edge(self.index, self.tail_index, self.head_index, self.fixed, dict(self.options))


@dataclass
class Facet:
    index: int
    edge_indices: List[int]
    fixed: bool = False
    options: Dict[str, Any] = field(default_factory=dict)

    def copy(self) -> "Facet":
        return Facet(self.index, list(self.edge_indices), self.fixed, dict(self.options))


@dataclass
class Body:
    index: int
    facet_indices: List[int]
    target_volume: Optional[float] = 0.0
    options: Dict[str, Any] = field(default_factory=dict)

    def copy(self) -> "Body":
        return Body(self.index, list(self.facet_indices), self.target_volume, dict(self.options))

    def compute_volume(self, mesh) -> float:
        """Divergence-theorem volume sum(v0 . (v1 x v2))/6 over the shell.

        Parity: reference geometry/body.py (vectorized volume); host-side
        numpy for commands/diagnostics — the hot path uses
        device.geo.body_volumes.
        """
        import numpy as np

        total = 0.0
        for fid in self.facet_indices:
            loop = mesh.facet_vertex_loop(mesh.facets[abs(int(fid))])
            if len(loop) != 3:
                continue
            v0, v1, v2 = (np.asarray(mesh.vertices[v].position, float) for v in loop)
            vol = float(np.dot(v0, np.cross(v1, v2)) / 6.0)
            total += -vol if int(fid) < 0 else vol
        return total

    def compute_volume_and_gradient(self, mesh):
        """(volume, {vertex_id: dV/dx}) — analytic divergence-theorem gradient."""
        import numpy as np

        grad: Dict[int, Any] = {}
        total = 0.0
        for fid in self.facet_indices:
            sign = -1.0 if int(fid) < 0 else 1.0
            loop = mesh.facet_vertex_loop(mesh.facets[abs(int(fid))])
            if len(loop) != 3:
                continue
            p = [np.asarray(mesh.vertices[v].position, float) for v in loop]
            total += sign * float(np.dot(p[0], np.cross(p[1], p[2])) / 6.0)
            contribs = (
                np.cross(p[1], p[2]),
                np.cross(p[2], p[0]),
                np.cross(p[0], p[1]),
            )
            for v, c in zip(loop, contribs):
                grad[v] = grad.get(v, 0.0) + sign * c / 6.0
        return total, grad
