"""Kozlov/Barnoy contact-parameter mapping for rim source strengths.

Counterpart of ``membrane_solver_tpu/energy/contact_mapping.py`` (the
reference's ``modules/energy/contact_mapping.py``):

    gamma_raw = h * (delta_epsilon / a)            (or a direct gamma)
    gamma     = gamma_raw * L0 / kappa_ref         (si/physical units only)

Resolution order for a rim-source module with ``strength_key`` (e.g.
``tilt_rim_source_strength_in``) and ``contact_suffix`` ("", "_in", "_out"):
1) the strength key itself (per-edge option, then global);
2) ``tilt_rim_source_contact_gamma{suffix}`` (direct line strength);
3) ``tilt_rim_source_contact_h{suffix}`` x
   ``tilt_rim_source_contact_delta_epsilon_over_a{suffix}`` (or
   delta_epsilon / a separately); suffixed keys fall back to unsuffixed.
Units: ``tilt_rim_source_contact_units`` in {solver (default), si/physical}
with ``tilt_rim_source_contact_length_unit_m`` / ``_kappa_ref_J``.

Host-side (compile-time) resolution: the strengths become per-edge tables of
the compiled extras, or scalars of the params dict.  Plain Python, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ContactStrength:
    gamma: float
    gamma_raw: float | None


def _convert_units(get, gamma_raw: float) -> float:
    units = str(get("tilt_rim_source_contact_units") or "solver").strip().lower()
    if units in {"solver", "sim", "simulation", "dimensionless"}:
        return float(gamma_raw)
    if units not in {"si", "physical", "physical_si"}:
        return float(gamma_raw)
    length_unit_m = get("tilt_rim_source_contact_length_unit_m")
    kappa_ref_j = get("tilt_rim_source_contact_kappa_ref_J")
    if length_unit_m is None or kappa_ref_j is None:
        return float(gamma_raw)
    length_unit_m = float(length_unit_m)
    kappa_ref_j = float(kappa_ref_j)
    if abs(length_unit_m) < 1e-30 or abs(kappa_ref_j) < 1e-30:
        return float(gamma_raw)
    return float(gamma_raw) * length_unit_m / kappa_ref_j


def resolve_contact_line_strength(
    gp,
    edge_options: dict | None,
    *,
    strength_key: str,
    contact_suffix: str = "",
) -> ContactStrength:
    """Resolve gamma for one rim edge (edge option overrides global)."""

    def get(base: str):
        if edge_options and base in edge_options:
            return edge_options[base]
        return gp.get(base)

    def get_suffixed(base: str):
        val = get(f"{base}{contact_suffix}")
        if val is not None or not contact_suffix:
            return val
        return get(base)

    val = get(strength_key)
    if val is not None:
        return ContactStrength(gamma=float(val), gamma_raw=None)

    gamma_direct = get_suffixed("tilt_rim_source_contact_gamma")
    if gamma_direct is not None:
        raw = float(gamma_direct)
        return ContactStrength(gamma=_convert_units(get, raw), gamma_raw=raw)

    h = get_suffixed("tilt_rim_source_contact_h")
    if h is None:
        return ContactStrength(gamma=0.0, gamma_raw=None)
    de_over_a = get_suffixed("tilt_rim_source_contact_delta_epsilon_over_a")
    if de_over_a is None:
        de = get_suffixed("tilt_rim_source_contact_delta_epsilon")
        a = get_suffixed("tilt_rim_source_contact_a")
        if de is None or a is None:
            return ContactStrength(gamma=0.0, gamma_raw=None)
        de_over_a = float(de) / float(a)
    raw = float(h) * float(de_over_a)
    return ContactStrength(gamma=_convert_units(get, raw), gamma_raw=raw)
