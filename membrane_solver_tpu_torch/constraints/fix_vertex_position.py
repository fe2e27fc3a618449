"""Placeholder for a constraint that fixes a vertex at a specified position.

Counterpart of ``membrane_solver_tpu/constraints/fix_vertex_position.py``,
an empty placeholder there too: per-vertex fixing is the ``fixed`` flag,
which the solver enforces through the fixed-row mask.
"""
