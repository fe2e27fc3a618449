"""Diagnostics: Gauss-Bonnet invariants, audit logging, patch overlays (host side)."""
