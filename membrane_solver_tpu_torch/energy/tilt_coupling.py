"""Inter-leaflet tilt coupling: E = 1/2 k_c integral |t_out +/- t_in|^2 dA.

Counterpart of ``membrane_solver_tpu/energy/tilt_coupling.py``:

    E = sum_tri 0.5 * k_c * (|d_0|^2 + |d_1|^2 + |d_2|^2)/3 * A_tri
    d_i = t_out_i + sign * t_in_i       (corner tilts)

sign = -1 for ``tilt_coupling_mode: difference``, +1 for ``sum``; the
misspelled legacy alias ``tilt_couping_mode`` is accepted.  The shape
gradient goes through the live area with the tilt mismatch frozen, the
tilt gradient through the mismatch with the area frozen (``x - x.detach()``
where the JAX package writes ``x - stop_gradient(x)``).  Zero when the mode
is unset or unrecognized.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.energy import param

USES_TILT_LEAFLETS = True


def _resolve_sign(spec) -> float | None:
    mode = spec.option("tilt_coupling_mode", None) or spec.option("tilt_couping_mode", None)
    if mode is None:
        return None
    mode = str(mode).strip().lower()
    if mode in ("difference", "diff", "minus", "sub"):
        return -1.0
    if mode in ("sum", "add", "plus"):
        return 1.0
    return None


def make_energy(spec):
    sign = _resolve_sign(spec)

    def fn(geo, state, topo, params):
        x = state.positions
        if sign is None:
            return x.new_zeros(())
        k_c = param(params, "tilt_coupling_modulus", like=x)
        live_geo = dgeo.triangle_geometry(x, topo.tri_rows, topo.tri_valid)
        d = state.tilts_out[topo.tri_rows] + sign * state.tilts_in[topo.tri_rows]
        sq = torch.sum(d * d, dim=(1, 2)) / 3.0
        area_term = torch.sum(torch.where(topo.tri_valid, sq.detach() * live_geo.area, 0.0))
        tilt_term = torch.sum(torch.where(topo.tri_valid, sq * live_geo.area.detach(), 0.0))
        return 0.5 * k_c * (area_term + tilt_term - tilt_term.detach())

    return fn
