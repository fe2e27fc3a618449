"""Surface tension energy: E = sum_f gamma_f * A_f.

Counterpart of ``membrane_solver_tpu/energy/surface.py``.  The per-triangle
energies and their corner gradients come from one pass of
``kernels.tri_kernels.surface_energies`` (the CUDA kernel for a CUDA
tensor, its plain twin on the CPU); the shape gradient is the corner
gradients' scatter to the vertices, which equals autograd through the
masked area.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.kernels import tri_kernels

USES_TILT = False
USES_TILT_LEAFLETS = False


def energy(geo, state, topo, params):
    gamma = torch.where(topo.tri_valid, topo.tri_surface_tension, 0.0)
    return torch.sum(tri_kernels.surface_energies(state.positions, topo.tri_rows, gamma))
