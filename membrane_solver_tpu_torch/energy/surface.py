"""Surface tension energy: E = sum_f gamma_f * A_f.

Counterpart of ``membrane_solver_tpu/energy/surface.py``; the gradient comes
from autograd through the masked area.
"""

from __future__ import annotations

import torch

USES_TILT = False
USES_TILT_LEAFLETS = False


def energy(geo, state, topo, params):
    return torch.sum(topo.tri_surface_tension * geo.area)
