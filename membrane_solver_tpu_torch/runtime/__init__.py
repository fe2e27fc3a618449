"""Minimization runtime: refinement, the tilt relax, the outer loop and the Minimizer."""
