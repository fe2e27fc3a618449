"""Inner-leaflet caveolin rim source: E = -sum gamma L (t_in_avg . r_hat).

Counterpart of ``membrane_solver_tpu/energy/tilt_rim_source_in.py``
(see ``_rim_source.py`` for the shared discretization and frame rules).
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import _rim_source

USES_TILT_LEAFLETS = True
IS_EXTERNAL_WORK = True

compile_topology = _rim_source.build_compile_topology(
    "tilt_rim_source_in", "tilt_rim_source_group_in", "tilt_rim_source_strength_in", "_in",
)


def energy(geo, state, topo, params):
    return _rim_source.rim_source_energy(
        state, topo, params,
        prefix="tilt_rim_source_in",
        strength_key="tilt_rim_source_strength_in",
        fields=("tilts_in",),
    )
