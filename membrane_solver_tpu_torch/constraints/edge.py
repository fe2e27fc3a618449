"""Placeholder (empty in the reference: modules/constraints/edge.py); loads as a no-op."""
