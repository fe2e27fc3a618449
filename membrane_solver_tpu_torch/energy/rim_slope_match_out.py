"""Soft rim matching energy (the penalty form of the kinematic rim condition).

Counterpart of ``membrane_solver_tpu/energy/rim_slope_match_out.py``:

    E = 1/2 k sum_i w_i ((t_out . r_hat)_i - phi_i)^2
      + 1/2 k sum_i w_i ((t_in  . r_hat)_i - (theta_disk - phi_i))^2   (disk group)

with phi_i = (h_out - h_rim) * inv_dr about (center, normal), w_i the rim
arc-length weights and k ``rim_slope_match_strength``.  theta_disk is the
disk ring's radial inner tilt, per vertex when the disk ring pairs 1:1 with
the rim (``local_disk``) and its arc-length-weighted mean otherwise; the
soft form never reads ``rim_slope_match_thetaB_param``.  Only the heights
of phi are live (small-slope shape gradient): the radial geometry, the
weights and the directions come from detached positions.  The ring
topology and the matching payload are the hard constraint's
(``constraints/rim_slope_match_out``), under this module's extras prefix.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.constraints import rim_slope_match_out as rim
from membrane_solver_tpu_torch.device.reduce import tree_sum
from membrane_solver_tpu_torch.energy import param

USES_TILT_LEAFLETS = True

_PREFIX = "energy:rim_slope_match_out"

compile_topology = rim.compile_topology
compile_static = rim.compile_static


def make_energy(spec):
    flags = rim._spec_flags(spec, key=_PREFIX)
    if flags is None:
        return lambda geo, state, topo, params: state.positions.new_zeros(())

    def fn(geo, state, topo, params):
        if f"{_PREFIX}/rim" not in topo.extras:
            return state.positions.new_zeros(())
        positions = state.positions
        k_match = param(params, "rim_slope_match_strength", like=positions)
        frozen = positions.detach()
        valid, _phi, inv_dr, r_hat, weights, normal, omap = rim.matching_data(
            frozen, topo, flags.interp_outer, prefix=_PREFIX)
        rim_rows = rim._x(topo, "rim", _PREFIX)
        outer_rows = rim._x(topo, "outer", _PREFIX)
        idx0, idx1, w0, w1 = omap
        center = rim._x(topo, "center", _PREFIX).to(positions.dtype)

        # live heights, detached radial geometry
        h_rim = torch.sum((positions[rim_rows] - center) * normal, dim=1)
        h_out = w0 * torch.sum((positions[outer_rows[idx0]] - center) * normal, dim=1) \
            + w1 * torch.sum((positions[outer_rows[idx1]] - center) * normal, dim=1)
        phi = torch.where(valid, (h_out - h_rim) * inv_dr, 0.0)

        diff_out = torch.sum(state.tilts_out[rim_rows] * r_hat, dim=1) - phi
        E = 0.5 * k_match * tree_sum(torch.where(valid, weights * diff_out**2, 0.0))
        if flags.has_disk:
            disk, dgood, disk_r_hat, dw = rim._disk_geometry(frozen, topo, prefix=_PREFIX)
            theta_vals = torch.sum(state.tilts_in[disk] * disk_r_hat, dim=1)
            if flags.local_disk:
                theta_i = theta_vals
            else:
                wsum = tree_sum(torch.where(dgood, dw, 0.0))
                theta_i = (tree_sum(torch.where(dgood, dw * theta_vals, 0.0))
                           / rim._fmax_tiny(wsum)).expand_as(phi)
            diff_in = torch.sum(state.tilts_in[rim_rows] * r_hat, dim=1) - (theta_i - phi)
            E = E + 0.5 * k_match * tree_sum(torch.where(valid, weights * diff_in**2, 0.0))
        return E

    return fn


def energy(geo, state, topo, params):
    return state.positions.new_zeros(())
