"""Outer-leaflet caveolin rim source: E = -sum gamma L (t_out_avg . r_hat).

Counterpart of ``membrane_solver_tpu/energy/tilt_rim_source_out.py``
(see ``_rim_source.py`` for the shared discretization and frame rules).
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import _rim_source

USES_TILT_LEAFLETS = True
IS_EXTERNAL_WORK = True

compile_topology = _rim_source.build_compile_topology(
    "tilt_rim_source_out", "tilt_rim_source_group_out", "tilt_rim_source_strength_out", "_out",
)


def energy(geo, state, topo, params):
    return _rim_source.rim_source_energy(
        state, topo, params,
        prefix="tilt_rim_source_out",
        strength_key="tilt_rim_source_strength_out",
        fields=("tilts_out",),
    )
