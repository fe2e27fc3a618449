"""Shape-aware curved local-interface law (z shape gradients included).

Counterpart of ``membrane_solver_tpu/energy/curved_local_interface_law.py``
(see ``_local_interface.py``): strength ``curved_local_interface_law_strength``;
the z of phi stays live, so autograd gives the z-only shape gradients.
"""

from __future__ import annotations

from membrane_solver_tpu_torch.energy import _local_interface

USES_TILT_LEAFLETS = True

compile_topology = _local_interface.compile_topology_pairs


def energy(geo, state, topo, params):
    return _local_interface.interface_energy(
        state, topo, params,
        prefix="curved_local_interface_law",
        strength_key="curved_local_interface_law_strength",
        live_z=True,
    )
