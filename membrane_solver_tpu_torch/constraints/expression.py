"""Expression-based hard constraints.

Counterpart of ``membrane_solver_tpu/constraints/expression.py``: entities
with ``constraint_expression`` (and ``constraint_target``) contribute one
KKT row (the expression's gradient over the entity's vertices) and are
projected by Newton steps ``x -= (g(x) - target) * grad g / |grad g|^2``
(5 iterations, tol 1e-12).  Each distinct expression compiles once
(``core/expr.compile_expr``); the value is taken at the vertex, the edge
midpoint or the facet centroid, and the gradient is ``torch.func.grad``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from membrane_solver_tpu_torch.core.expr import compile_expr, expr_free_names

TOL = 1e-12
MAX_ITER = 5


def _spec_of(options):
    opts = options or {}
    expr = opts.get("constraint_expression") or opts.get("expression_constraint")
    target = opts.get("constraint_target")
    if target is None:
        target = opts.get("expression_target")
    if expr is None or target is None:
        return None
    return str(expr), float(target)


def _collect(layout):
    """(expr, target, kind, slot) tuples for all constrained entities."""
    mesh = layout.mesh
    out = []
    for vid, v in mesh.vertices.items():
        spec = _spec_of(v.options)
        if spec:
            out.append((spec[0], spec[1], 0, layout.row_of[int(vid)]))
    for eid, e in mesh.edges.items():
        spec = _spec_of(e.options)
        slot = layout.edge_slot_of.get(int(eid))
        if spec and slot is not None:
            out.append((spec[0], spec[1], 1, slot))
    for fid, f in mesh.facets.items():
        spec = _spec_of(f.options)
        slot = layout.tri_slot_of.get(int(fid))
        if spec and slot is not None:
            out.append((spec[0], spec[1], 2, slot))
    return out


def compile_static(layout):
    return tuple((e, t, k) for (e, t, k, _s) in _collect(layout))


def compile_topology(layout) -> dict:
    slots = [s for (_e, _t, _k, s) in _collect(layout)]
    return {"slots": np.asarray(slots or [0], dtype=np.int64)}


def _entity_value_fn(expr: str, kind: int, topo, params):
    """(positions, slot) -> the expression's value at one entity."""
    extra = sorted(n for n in expr_free_names(expr) if n in params)
    compiled = compile_expr(expr, ["x", "y", "z"] + extra)

    def value(positions, slot):
        if kind == 0:
            p = positions[slot]
        elif kind == 1:
            rows = topo.edge_rows[slot]
            p = 0.5 * (positions[rows[0]] + positions[rows[1]])
        else:
            rows = topo.tri_rows[slot]
            p = (positions[rows[0]] + positions[rows[1]] + positions[rows[2]]) / 3.0
        return compiled(p[0], p[1], p[2], *[params[n] for n in extra])

    return value


def _value_and_grad(value, positions, slot):
    """The value and its dense gradient (zero where the expression ignores the positions).

    ``torch.func.grad``, so the parameter sweep can map it over its members.
    """
    def fn(x):
        val = torch.as_tensor(value(x, slot), dtype=positions.dtype, device=positions.device)
        return val, val

    g, val = torch.func.grad(fn, has_aux=True)(positions.detach())
    return val, g


def make_constraint_gradient_rows(spec):
    table = spec.static_of("constraint:expression", ())

    def fn(state, topo, params):
        if not table:
            return None
        slots = topo.extras["constraint:expression/slots"]
        return torch.stack([
            _value_and_grad(_entity_value_fn(expr, kind, topo, params), state.positions,
                            slots[i])[1]
            for i, (expr, _target, kind) in enumerate(table)
        ])

    return fn


def make_enforce(spec):
    table = spec.static_of("constraint:expression", ())

    def enforce(state, topo, params, context: str = "minimize"):
        if not table:
            return state
        positions = state.positions
        slots = topo.extras["constraint:expression/slots"]
        movable = (~topo.fixed_mask)[:, None].to(positions.dtype)
        for i, (expr, target, kind) in enumerate(table):
            value = _entity_value_fn(expr, kind, topo, params)
            for _ in range(MAX_ITER):
                val, g = _value_and_grad(value, positions, slots[i])
                delta = val - target
                norm_sq = torch.sum(g * g)
                lam = delta / (norm_sq + 1e-18)
                needs = (torch.abs(delta) >= TOL) & (norm_sq >= 1e-18)
                positions = torch.where(needs, positions - lam * g * movable, positions)
        return dataclasses.replace(state, positions=positions)

    return enforce
