"""Placeholder (empty in the reference: modules/constraints/fix_facet_angle.py); loads as a no-op."""
