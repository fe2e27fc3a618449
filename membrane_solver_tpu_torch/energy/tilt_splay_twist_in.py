"""Inner-leaflet split splay/twist tilt-gradient energy (Kozlov-Hamm split).

Counterpart of ``membrane_solver_tpu/energy/tilt_splay_twist_in.py``:

    E = 1/2 sum_tri A * (k_splay * div_eval^2 + k_twist * (curl(t).n_hat)^2)

with the P1 operators div = sum t_i.g_i and curl.n = sum (g_i x t_i).n_hat
on frozen positions (a tilt gradient only, as in the JAX package).

- ``tilt_splay_modulus_in`` falls back to ``bending_modulus_in`` then
  ``bending_modulus``; ``tilt_twist_modulus_in`` to ``tilt_twist_modulus``.
- ``tilt_divergence_mode_in`` (fallback ``tilt_divergence_mode``):
  ``native`` squares the triangle divergence; ``vertex_recovered`` the mean
  of the corners' area-weighted vertex divergences (two vertex sums over
  the corner CSR, in its fixed order).
- ``tilt_transport_model`` ``ambient_v1`` (default) takes div, the areas
  and the P1 gradients from ``tri_kernels.p1_triangle_divergence`` (one
  call of the divergence kernel forward, its weighted vertex sum backward);
  ``connection_v1`` first rotates each corner tilt into the triangle plane
  (as ``tilt_smoothness`` does) and applies :func:`geo.p1_shape_gradients`.
"""

from __future__ import annotations

import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.reduce import tree_sum
from membrane_solver_tpu_torch.energy import param
from membrane_solver_tpu_torch.energy.tilt_smoothness import minimal_rotation
from membrane_solver_tpu_torch.kernels import tri_kernels

USES_TILT_LEAFLETS = True


def divergence_mode(spec) -> str:
    return (spec.option("tilt_divergence_mode_in", "")
            or spec.option("tilt_divergence_mode", "native")).strip().lower()


def make_energy(spec):
    div_mode = divergence_mode(spec)
    transport = spec.option("tilt_transport_model", "ambient_v1").strip().lower()

    def fn(geo, state, topo, params):
        tilts = state.tilts_in
        k_splay = param(params, "tilt_splay_modulus_in", "bending_modulus_in", "bending_modulus",
                        like=tilts)
        k_twist = param(params, "tilt_twist_modulus_in", "tilt_twist_modulus", like=tilts)
        frozen = state.positions.detach()
        valid = topo.tri_valid
        csr = topo.corner_csr()
        fgeo = dgeo.triangle_geometry(frozen, topo.tri_rows, valid)
        if transport == "connection_v1":
            vnorm = dgeo.vertex_normals(fgeo, valid, csr)
            t0, t1, t2 = (minimal_rotation(tilts[rows], vnorm[rows], fgeo.unit_normal)
                          for rows in topo.tri_rows.unbind(1))
            g = dgeo.p1_shape_gradients(fgeo)
            area = fgeo.area
            div_tri = (torch.sum(t0 * g[:, 0], dim=1) + torch.sum(t1 * g[:, 1], dim=1)
                       + torch.sum(t2 * g[:, 2], dim=1))
            div_tri = torch.where(valid, div_tri, 0.0)
        else:
            div_tri, area, g = tri_kernels.p1_triangle_divergence(frozen, tilts, topo.tri_rows,
                                                                  valid, csr)
            t0, t1, t2 = (tilts[rows] for rows in topo.tri_rows.unbind(1))

        if div_mode == "vertex_recovered":
            w = torch.where(valid, area, 0.0)
            wd = w * div_tri
            v_area = dgeo.scatter_add_rows(w, w, w, csr)
            num = dgeo.scatter_add_rows(wd, wd, wd, csr)
            v_div = torch.where(v_area > 1e-20, num / torch.clamp(v_area, min=1e-20), 0.0)
            div_eval = sum(v_div[rows] for rows in topo.tri_rows.unbind(1)) / 3.0
        else:
            div_eval = div_tri

        curl_vec = (torch.linalg.cross(g[:, 0], t0) + torch.linalg.cross(g[:, 1], t1)
                    + torch.linalg.cross(g[:, 2], t2))
        curl_n = torch.where(valid, torch.sum(curl_vec * fgeo.unit_normal, dim=1), 0.0)
        density = k_splay * div_eval * div_eval + k_twist * curl_n * curl_n
        return 0.5 * tree_sum(torch.where(valid, area * density, 0.0))

    return fn
