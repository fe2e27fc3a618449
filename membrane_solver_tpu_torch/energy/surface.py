"""Surface tension energy: E = sum_f gamma_f * A_f.

Counterpart of ``membrane_solver_tpu/energy/surface.py``.  One call of
``kernels.tri_kernels.surface_energy`` (the CUDA kernel for a CUDA tensor,
its plain twin on the CPU) masks the tension by ``tri_valid``, sums the
energy and, when the positions require grad, sums the corner gradients to
the vertices, which equals autograd through the masked area.
"""

from __future__ import annotations

from membrane_solver_tpu_torch.kernels import tri_kernels

USES_TILT = False
USES_TILT_LEAFLETS = False


def energy(geo, state, topo, params):
    x = state.positions
    return tri_kernels.surface_energy(x, topo.tri_rows, topo.tri_valid, topo.tri_surface_tension,
                                      topo.corner_csr(), tri_kernels.workspace(topo, x))
