"""Inner-leaflet soft disk tilt-profile target.

Counterpart of ``membrane_solver_tpu/energy/tilt_disk_target_in.py`` (see
``_disk_target.py`` for the shared Bessel-profile discretization).
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import _disk_target

USES_TILT_LEAFLETS = True

compile_topology = _disk_target.build_compile_topology("tilt_disk_target_in", "_in")
compile_static = _disk_target.build_compile_static("tilt_disk_target_in", "_in")


def make_energy(spec):
    has_normal = bool((spec.static_of("energy:tilt_disk_target_in") or (False,))[0])

    def energy(geo, state, topo, params):
        return _disk_target.disk_target_energy(
            state, topo, params, prefix="tilt_disk_target_in", sfx="_in", field="tilts_in",
            has_normal=has_normal,
        )

    return energy
