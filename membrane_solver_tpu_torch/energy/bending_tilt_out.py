"""Outer-leaflet bending-tilt coupling (kappa_key=bending_modulus_out, div_sign=1.0).

Counterpart of ``membrane_solver_tpu/energy/bending_tilt_out.py``: under
``bending_tilt_interface_divergence_mode`` (``_out``, or
``bending_tilt_out_interface_divergence_mode``) ``trace_reconstructed_v1``
the trace-touching triangles take the reconstructed divergence
(``bending_tilt_leaflet._reconstruct_trace_divergence``) on the compiled
scaffold masks.  The base-term overrides (flat reference, assume-J0
presets, the ``physical_disk_split_v1`` region) act as
``bending_tilt_leaflet`` describes.
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import bending_tilt_leaflet as _bt
from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles

USES_TILT_LEAFLETS = True

_KW = dict(kappa_key="bending_modulus_out", div_sign=1.0, c0_key="spontaneous_curvature_out")


def make_energy(spec):
    recovered = _bt.recovered_mode(spec, "out")
    zero_base = _bt.zero_base_mode(spec, "out")
    idiv_on = _bt.interface_divergence_mode_static(spec, "out") == "trace_reconstructed_v1"

    def fn(geo, state, topo, params):
        return _bt.leaflet_bending_tilt_energy(
            state, topo, params, tilts=state.tilts_out,
            tri_present=present_triangles(topo, "out"), zero_base=zero_base,
            j0_mask=_bt.combined_zero_mask(topo, "out"), recovered_div=recovered,
            idiv_masks=_bt.scaffold_masks(topo, "out") if idiv_on else None,
            **_KW,
        )

    return fn


def make_tilt_frozen(spec):
    """Frozen-geometry split for the inner tilt solve (positions constant)."""
    return _bt.make_leaflet_bending_tilt_frozen(spec, leaflet="out", **_KW)


def compile_topology(layout) -> dict:
    out = _bt.compile_base_masks(layout, "out")
    gp = layout.mesh.global_parameters
    raw = (gp.get("bending_tilt_interface_divergence_mode_out")
           or gp.get("bending_tilt_out_interface_divergence_mode")
           or gp.get("bending_tilt_interface_divergence_mode"))
    if str(raw or "p1_triangle").strip().lower() == "trace_reconstructed_v1":
        tr, su, rl = _bt.compile_scaffold_row_masks(layout)
        out.update(scaffold_trace=tr, scaffold_support=su, scaffold_release=rl)
    return out
