"""Safe arithmetic expression evaluation.

Copy of ``membrane_solver_tpu/core/expr.py``; besides the import paths,
only ``compile_expr``'s function table differs (torch instead of
``jax.numpy``).

Parity: reference ``core/expr_eval.py`` (AST-whitelist evaluator used by
``defines:`` blocks and expression energies/constraints).

Besides scalar host evaluation (`eval_expr`), expressions can be
*compiled once* into a torch callable (`compile_expr`) so the
expression energy/constraint modules evaluate vectorized on device instead of
re-walking the AST per entity per step.
"""

from __future__ import annotations

import ast
import math
from typing import Any, Callable, Dict, Mapping, Sequence

_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.Pow: lambda a, b: a**b,
    ast.Mod: lambda a, b: a % b,
}

_CONSTANTS = {"pi": math.pi, "e": math.e}


def _function_table(np_like) -> Dict[str, Callable]:
    return {
        "sin": np_like.sin,
        "cos": np_like.cos,
        "tan": np_like.tan,
        "sqrt": np_like.sqrt,
        "abs": abs if np_like is math else np_like.abs,
        "log": np_like.log,
        "exp": np_like.exp,
        "min": min if np_like is math else np_like.minimum,
        "max": max if np_like is math else np_like.maximum,
    }


def _evaluate(node: ast.AST, names: Mapping[str, Any], funcs: Dict[str, Callable]):
    if isinstance(node, ast.Expression):
        return _evaluate(node.body, names, funcs)
    if isinstance(node, ast.BinOp):
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise ValueError(f"Unsupported operator: {ast.dump(node.op)}")
        return op(_evaluate(node.left, names, funcs), _evaluate(node.right, names, funcs))
    if isinstance(node, ast.UnaryOp):
        val = _evaluate(node.operand, names, funcs)
        if isinstance(node.op, ast.UAdd):
            return val
        if isinstance(node.op, ast.USub):
            return -val
        raise ValueError("Unsupported unary operator")
    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name) or node.func.id not in funcs:
            raise ValueError("Unsupported function")
        args = [_evaluate(a, names, funcs) for a in node.args]
        return funcs[node.func.id](*args)
    if isinstance(node, ast.Name):
        if node.id in names:
            return names[node.id]
        if node.id in _CONSTANTS:
            return _CONSTANTS[node.id]
        raise ValueError(f"Unknown name: {node.id}")
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float)):
            return float(node.value)
        raise ValueError("Unsupported literal")
    raise ValueError(f"Unsupported expression node: {type(node).__name__}")


def eval_expr(expr: str, names: Mapping[str, float] | None = None) -> float:
    """Evaluate ``expr`` with math semantics on the host; raises on non-whitelisted syntax."""
    tree = ast.parse(str(expr), mode="eval")
    return float(_evaluate(tree, dict(names or {}), _function_table(math)))


def expr_free_names(expr: str) -> set[str]:
    """Return the free variable names used by ``expr`` (excluding pi/e and functions)."""
    tree = ast.parse(str(expr), mode="eval")
    funcs = set(_function_table(math))
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id not in funcs and node.id not in _CONSTANTS:
            out.add(node.id)
    return out


def compile_expr(expr: str, arg_names: Sequence[str]) -> Callable:
    """Compile ``expr`` into a function of the given arguments over tensors.

    The returned callable accepts positional arguments matching ``arg_names``
    (scalars or tensors) and evaluates with ``torch`` semantics, so it can
    run vectorized inside energy kernels.
    """
    import torch

    tree = ast.parse(str(expr), mode="eval")
    funcs = _function_table(torch)
    arg_names = list(arg_names)

    def fn(*args):
        if len(args) != len(arg_names):
            raise TypeError(f"expected {len(arg_names)} args, got {len(args)}")
        return _evaluate(tree, dict(zip(arg_names, args)), funcs)

    fn.__name__ = f"expr<{expr}>"
    return fn
