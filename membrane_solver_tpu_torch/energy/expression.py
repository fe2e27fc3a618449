"""User-defined expression energies over vertices, edges, facets and bodies.

Counterpart of ``membrane_solver_tpu/energy/expression.py``: entities
carrying an ``expression`` / ``energy_expression`` / ``expr`` option
contribute

    E = sum_entities expr(x, y, z, <globals>) * measure

with the measure selected by ``expression_measure``: "point" (vertices,
the default), "length" (edges), "area" (facets), "volume" (bodies).  Each
distinct expression compiles once (``core/expr.compile_expr``, a torch
function table) and is evaluated over all its entities at once; the
gradient is autograd's.  Variables: x, y, z (the vertex position or the
entity's centroid) plus any scalar global parameter in ``params``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from membrane_solver_tpu_torch.core.expr import compile_expr, expr_free_names
from membrane_solver_tpu_torch.device import geo as dgeo

USES_TILT = False
USES_TILT_LEAFLETS = False

_EXPR_KEYS = ("expression", "energy_expression", "expr")
_DEFAULT_MEASURE = {0: "point", 1: "length", 2: "area", 3: "volume"}


def _expr_of(options) -> str | None:
    for key in _EXPR_KEYS:
        val = (options or {}).get(key)
        if val is not None:
            return str(val)
    return None


def _collect_groups(layout) -> Dict[tuple, List[int]]:
    mesh = layout.mesh
    groups: Dict[tuple, List[int]] = {}

    def note(kind, slot, options):
        expr = _expr_of(options)
        if expr is None or slot is None:
            return
        measure = str((options or {}).get("expression_measure") or _DEFAULT_MEASURE[kind])
        groups.setdefault((expr, measure, kind), []).append(slot)

    for vid, v in mesh.vertices.items():
        note(0, layout.row_of[int(vid)], v.options)
    for eid, e in mesh.edges.items():
        note(1, layout.edge_slot_of.get(int(eid)), e.options)
    for fid, f in mesh.facets.items():
        note(2, layout.tri_slot_of.get(int(fid)), f.options)
    for bid, b in mesh.bodies.items():
        note(3, layout.body_slot_of[int(bid)], b.options)
    return groups


def compile_static(layout):
    """Hashable (expr, measure, kind) table, index == group id."""
    return tuple(_collect_groups(layout).keys())


def compile_topology(layout) -> dict:
    rows: List[int] = []
    gids: List[int] = []
    for g, slots in enumerate(_collect_groups(layout).values()):
        rows.extend(slots)
        gids.extend([g] * len(slots))
    return {
        "rows": np.asarray(rows or [0], dtype=np.int64),
        "gid": np.asarray(gids or [0], dtype=np.int64),
        "valid": np.ones(len(rows), dtype=bool) if rows else np.zeros(1, dtype=bool),
    }


def make_energy(spec):
    exprs = spec.static_of("energy:expression", ())

    def fn(geo, state, topo, params):
        positions = state.positions
        total = positions.new_zeros(())
        if not exprs:
            return total
        rows = topo.extras["energy:expression/rows"]
        gid = topo.extras["energy:expression/gid"]
        valid = topo.extras["energy:expression/valid"]
        ones = positions.new_ones(rows.shape[0])
        for g, (expr, measure, kind) in enumerate(exprs):
            extra = sorted(n for n in expr_free_names(expr) if n in params)
            compiled = compile_expr(expr, ["x", "y", "z"] + extra)
            mine = valid & (gid == g)
            weight = ones
            if kind == 0:
                pts = positions[rows]
            elif kind == 1:
                t = positions[topo.edge_rows[rows][:, 0]]
                h = positions[topo.edge_rows[rows][:, 1]]
                pts = 0.5 * (t + h)
                if measure == "length":
                    weight = dgeo.safe_norm(h - t)
            elif kind == 2:
                tri = topo.tri_rows[rows]
                pts = (positions[tri[:, 0]] + positions[tri[:, 1]] + positions[tri[:, 2]]) / 3.0
                if measure == "area":
                    weight = geo.area[rows]
            else:
                pts = positions.new_zeros((rows.shape[0], 3))
                if measure == "volume":
                    vols = dgeo.body_volumes(positions, topo.tri_rows, topo.tri_valid,
                                             topo.tri_body, topo.body_valid.shape[0])
                    weight = vols[rows]
            vals = compiled(pts[:, 0], pts[:, 1], pts[:, 2], *[params[n] for n in extra])
            total = total + torch.sum(torch.where(mine, vals * weight, 0.0))
        return total

    return fn


def energy(geo, state, topo, params):  # breakdown fallback (no static table)
    return state.positions.new_zeros(())
