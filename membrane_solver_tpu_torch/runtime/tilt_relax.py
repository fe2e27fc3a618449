"""Tilt relaxation (the inner solves), positions frozen.

Counterpart of ``membrane_solver_tpu/runtime/tilt_relax.py``.
``make_relax_leaflet_tilts`` relaxes both leaflet fields:

1. enforce the tilt constraints and tangent-project both leaflet fields;
2. evaluate the tilt energy and its gradient for both leaflets, project
   the gradient against the tilt-constraint rows (KKT, factored once per
   call; compact slot rows, or every module's dense rows when one has no
   compact form), zero the fixed rows;
3. CG (Jacobi-preconditioned by default, beta = rz_new / rz_old) or GD,
   each with 12-halving backtracking accept-if-not-worse on
   tangent-projected trials with fixed-row overrides and a constraint
   refresh after each accepted step (or once after the loop);
4. stop on zero gradient, tol convergence, rejection or max iters.

``make_relax_vertex_tilts`` runs the same CG or GD on the single ``tilts``
field, with no constraint rows and no refresh (its CG, too, runs without
the preconditioner when ``tilt_cg_preconditioner`` is none).

The JAX package runs these as ``lax.while_loop``s; here they are Python
loops, and each accept/stop decision reads a device scalar (a host sync).
Its batched line search (a TPU device choice) is not ported: both forms
take the same decisions, and the port runs the sequential one.  At float32
the four triangle energies of the leaflet lane go through the fused
frozen-tilt entry point (``kernels/frozen_tilt``) on every device: one call
of the CUDA kernels for CUDA tensors, which gathers the corners, sums the
energy and scatters the vertex gradients itself, and its plain twin on the
CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from membrane_solver_tpu_torch.device import geo as dgeo
from membrane_solver_tpu_torch.device.state import MeshState, ProblemSpec, Topology, slot_csr
from membrane_solver_tpu_torch.energy import get_module, param
from membrane_solver_tpu_torch.kernels import tri_kernels
from membrane_solver_tpu_torch.kernels import vertex_sum

MAX_BACKTRACKS = 12
STEP_FLOOR = 1e-16
# when a list: each leaflet relax appends its accepted CG steps (a host int)
RELAX_RECORD = None


def _uses_tilts(module) -> bool:
    return bool(getattr(module, "USES_TILT", False) or getattr(module, "USES_TILT_LEAFLETS", False))


def spec_uses_leaflet_tilts(spec: ProblemSpec) -> bool:
    return any(
        getattr(get_module(name), "USES_TILT_LEAFLETS", False) for name in spec.energy_modules
    )


def spec_uses_vertex_tilts(spec: ProblemSpec) -> bool:
    return any(getattr(get_module(name), "USES_TILT", False) for name in spec.energy_modules)


def make_tilt_energy(spec: ProblemSpec) -> Callable:
    """Tilt-dependent total energy with the modules' in-loop objectives.

    The accept/reject tests of the inner solve involve only tilt-dependent
    modules; tilt_in/tilt_out score with their lumped in-loop form.
    """
    from membrane_solver_tpu_torch.runtime.jit_core import (
        active_energy_modules,
        module_scale_fn,
        scaled,
    )

    fns = []
    for name in active_energy_modules(spec):
        module = get_module(name)
        if not _uses_tilts(module):
            continue
        maker = getattr(module, "make_inloop_energy", None) or getattr(module, "make_energy", None)
        fn = maker(spec) if maker is not None else module.energy
        fns.append(scaled(fn, module_scale_fn(spec, name)))

    def tilt_energy(state: MeshState, topo: Topology, params: Dict):
        geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
        e = state.positions.new_zeros(())
        for fn in fns:
            e = e + fn(geo, state, topo, params)
        return e

    return tilt_energy


def make_tilt_enforcer(spec: ProblemSpec) -> Callable:
    """Kinematic tilt-constraint projection across modules."""
    from membrane_solver_tpu_torch.constraints import get_constraint

    fns = []
    for name in dict.fromkeys(spec.constraint_modules):
        maker = getattr(get_constraint(name), "make_enforce_tilts", None)
        fn = maker(spec) if maker is not None else None
        if fn is not None:
            fns.append(fn)

    def enforce(state, topo, params):
        for fn in fns:
            state = fn(state, topo, params)
        return state

    return enforce


def make_tilt_constraint_rows(spec: ProblemSpec) -> Callable:
    """rows(state, topo, params) -> stacked dense (k, 2, Nv, 3) (in, out) tilt rows, or None."""
    from membrane_solver_tpu_torch.constraints import get_constraint

    builders = []
    for name in dict.fromkeys(spec.constraint_modules):
        maker = getattr(get_constraint(name), "make_tilt_constraint_rows", None)
        if maker is not None:
            builders.append(maker(spec))

    def rows(state, topo, params):
        blocks = [b for b in (fn(state, topo, params) for fn in builders) if b is not None]
        return torch.cat(blocks) if blocks else None

    return rows


def make_tilt_projector(rows):
    """KKT projector over the (in, out) tilt DOFs from dense rows (k, 2, Nv, 3), or the identity.

    The normal-equation matrix is LU-factored once per relax call; each
    application is two matrix-vector products and a triangular solve pair.
    """
    if rows is None:
        return lambda gin, gout: (gin, gout)
    k = rows.shape[0]
    G = rows.reshape(k, -1)
    A = G @ G.T + 1e-18 * torch.eye(k, dtype=G.dtype, device=G.device)
    lu, piv, _info = torch.linalg.lu_factor_ex(A)

    def project(gin, gout):
        g = torch.cat([gin.reshape(-1), gout.reshape(-1)])
        lam = torch.linalg.lu_solve(lu, piv, (G @ g)[:, None])[:, 0]
        g = g - lam @ G
        n = gin.numel()
        return g[:n].reshape(gin.shape), g[n:].reshape(gout.shape)

    return project


def make_compact_tilt_collector(spec: ProblemSpec):
    """Collect the modules' compact tilt rows into one slot table.

    Returns collect(state, topo, params) -> (values (k, s, 3), rows (k, s),
    leaflet (k, s), backgrounds), or None when no module has tilt rows or
    one module's rows have no compact form (``make_compact_tilt_rows``
    missing or giving None, as the ring-average rim mode's aggregate rows
    do): the KKT system must see every row, so the relax then takes every
    module's dense rows (:func:`make_tilt_projector`).  A module block of
    fewer slots is zero-padded.  Each background is a rank-1 term
    (coefficients (k,), field (2, Nv, 3)).
    """
    from membrane_solver_tpu_torch.constraints import get_constraint

    builders = []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        if getattr(mod, "make_tilt_constraint_rows", None) is None:
            continue
        maker = getattr(mod, "make_compact_tilt_rows", None)
        fn = maker(spec) if maker is not None else None
        if fn is None:
            return None
        builders.append(fn)
    if not builders:
        return None

    def collect(state, topo, params):
        blocks = [b for b in (fn(state, topo, params) for fn in builders) if b is not None]
        if not blocks:
            return None
        s_max = max(b[0].shape[1] for b in blocks)
        k_total = sum(b[0].shape[0] for b in blocks)
        vs, rs, ls, bgs = [], [], [], []
        offset = 0
        for b in blocks:
            v, r, lf = b[:3]
            pad = s_max - v.shape[1]
            if pad:
                v = torch.nn.functional.pad(v, (0, 0, 0, pad))
                r = torch.nn.functional.pad(r, (0, pad))
                lf = torch.nn.functional.pad(lf, (0, pad))
            if len(b) == 5:
                c_full = v.new_zeros((k_total,))
                c_full[offset: offset + v.shape[0]] = b[3]
                bgs.append((c_full, b[4]))
            offset += v.shape[0]
            vs.append(v)
            rs.append(r)
            ls.append(lf)
        return torch.cat(vs), torch.cat(rs), torch.cat(ls), tuple(bgs)

    return collect


def make_compact_tilt_projector(compact, n_rows: int):
    """KKT projector over the (in, out) tilt DOFs from compact slot rows.

    The normal-equation matrix is assembled from slots (rows interact only
    where a slot vertex and leaflet agree) plus the rank-1 background cross
    terms, and LU-factored once per relax call; each application is a slot
    gather, a triangular solve pair and a slot sum (``vertex_sum.row_sum``
    over a slot CSR of the (leaflet, vertex) rows of ``n_rows`` vertices, in
    a fixed order: the in-rows of two constraints may share a vertex).  The
    rows follow the positions, so the CSR is built here with the factor.
    """
    if compact is None:
        return lambda gin, gout: (gin, gout)
    vals, rows, leaf, bgs = compact
    k = vals.shape[0]
    eq = (
        (rows[:, None, :, None] == rows[None, :, None, :])
        & (leaf[:, None, :, None] == leaf[None, :, None, :])
    ).to(vals.dtype)
    dots = torch.einsum("iac,jbc->ijab", vals, vals)
    A = torch.sum(dots * eq, dim=(2, 3))
    for c, f in bgs:
        fb = f[leaf, rows]
        s_vec = torch.einsum("iac,iac->i", vals, fb)
        A = A + c[:, None] * s_vec[None, :] + s_vec[:, None] * c[None, :]
    for c1, f1 in bgs:
        for c2, f2 in bgs:
            A = A + torch.sum(f1 * f2) * (c1[:, None] * c2[None, :])
    A = A + 1e-18 * torch.eye(k, dtype=vals.dtype, device=vals.device)
    lu, piv, _info = torch.linalg.lu_factor_ex(A)
    csr = slot_csr(leaf * n_rows + rows, 2 * n_rows)

    def project(gin, gout):
        g2 = torch.stack([gin, gout])
        b = torch.einsum("iac,iac->i", vals, g2[leaf, rows])
        for c, f in bgs:
            b = b + c * torch.sum(f * g2)
        lam = torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]
        corr = vertex_sum.row_sum((lam[:, None, None] * vals).reshape(-1, 3), csr)
        corr = corr.reshape(2, n_rows, 3)
        for c, f in bgs:
            corr = corr + torch.dot(lam, c) * f
        return gin - corr[0], gout - corr[1]

    return project


def jacobi_preconditioner(positions, topo, params):
    """(M_inv_in, M_inv_out): tilt-modulus mass plus bending cotan row sums."""
    from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles

    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    vertex_areas = dgeo.barycentric_vertex_areas(geo, topo.corner_csr())
    present_out = present_triangles(topo, "out")
    if present_out is not None:
        a3 = torch.where(present_out, geo.area, 0.0) / 3.0
        vertex_areas_out = dgeo.scatter_add_rows(a3, a3, a3, topo.corner_csr())
    else:
        vertex_areas_out = vertex_areas
    curv = tri_kernels.curvature_data(positions, topo.tri_rows, topo.tri_valid, topo.corner_csr())
    c0, c1, c2 = curv.weights[:, 0], curv.weights[:, 1], curv.weights[:, 2]

    def diag_for(k_tilt, k_smooth, fixed_mask, areas):
        diag = k_tilt * areas
        rowsum = dgeo.scatter_add_rows(
            0.5 * k_smooth * (c1 + c2),
            0.5 * k_smooth * (c2 + c0),
            0.5 * k_smooth * (c0 + c1),
            topo.corner_csr(),
        )
        diag = diag + rowsum
        diag = torch.where(diag > 1e-12, diag, 1.0)
        diag = torch.where(fixed_mask, 1.0, diag)
        return 1.0 / diag

    kb = param(params, "bending_modulus", like=positions)
    k_in = param(params, "tilt_modulus_in", like=positions)
    k_out = param(params, "tilt_modulus_out", like=positions)
    kb_in = params.get("bending_modulus_in", kb)
    kb_out = params.get("bending_modulus_out", kb)
    return (
        diag_for(k_in, kb_in, topo.tilt_fixed_in_mask, vertex_areas),
        diag_for(k_out, kb_out, topo.tilt_fixed_out_mask, vertex_areas_out),
    )


def collect_frozen_tilt_program(spec: ProblemSpec):
    """Frozen-geometry inner-solve program: (e_pre, e_fns, c_pre, c_fns, e_names), or None.

    Positions are constant for the whole inner solve, so every
    position-only field is computed once per relax call and each iteration
    evaluates only the tilt-dependent part.  As in the JAX package, a tilt
    energy without the ``make_tilt_frozen`` hook (``tilt``,
    ``tilt_smoothness``, ``tilt_coupling``) makes it None, and the relax
    evaluates the whole tilt energy per iteration instead.
    """
    from membrane_solver_tpu_torch.constraints import get_constraint
    from membrane_solver_tpu_torch.runtime.jit_core import active_energy_modules, module_scale_fn

    e_pre, e_fns, e_names = [], [], []
    for name in active_energy_modules(spec):
        module = get_module(name)
        if not _uses_tilts(module):
            continue
        hook = getattr(module, "make_tilt_frozen", None)
        if hook is None:
            return None
        pre, fn = hook(spec)
        sc = module_scale_fn(spec, name)
        if sc is not None:
            def fn(tin, tout, fr, topo, params, ctx=None, _fn=fn, _sc=sc):
                return _sc(params, tin) * _fn(tin, tout, fr, topo, params, ctx)
        e_pre.append(pre)
        e_fns.append(fn)
        e_names.append(name)
    c_pre, c_fns = [], []
    for name in dict.fromkeys(spec.constraint_modules):
        fhook = getattr(get_constraint(name), "make_frozen_enforce_tilts", None)
        out = fhook(spec) if fhook is not None else None
        if out is not None:
            c_pre.append(out[0])
            c_fns.append(out[1])
    return e_pre, e_fns, c_pre, c_fns, e_names


FUSED_NAMES = ("tilt_in", "tilt_out", "bending_tilt_in", "bending_tilt_out")


def build_fused_tilt_energy(spec, e_names, e_fns, e_frozen, topo, params, dtype):
    """The fused frozen-tilt energy, or None if ineligible.

    Eligible at float32 when all four triangle tilt modules are active, both
    leaflets keep the lumped tilt mass (``tilt_mass_mode`` consistent runs
    per module, as in the JAX package), the curved-theta ablation scales
    none of the modules (the kernel's k_vec carries no module scale) and the
    divergence is the per-triangle one: the kernel steps aside, as the JAX
    package's does, under a ``bending_tilt_in_update_mode`` other than off,
    under a tilt mass other than lumped (``diagonal`` too, though its energy
    is the lumped one), under the outer leaflet's ``trace_reconstructed_v1``
    interface divergence and under the recovered inner divergence (a
    non-empty ``theory_parity_lane``: ``smooth_w`` in the frozen fields),
    both of which mix triangles, and the relax runs the plain frozen
    program.
    Returns ``(FusedTiltEnergy, rest)``: the energy of vertex tilts, and
    ``rest`` the remaining (fn, frozen) pairs evaluated per module (none of
    them reads the shared corner gather, which the fused path no longer
    makes).  The entry point's scratch is allocated here, once per relax
    call.  Validity masks are folded into the payload: A and va are zero
    wherever the per-module path masks the term, and g is zero on invalid
    triangles.  The Dirichlet smoothness of ``tilt_smoothness_{in,out}``
    folds into the same pass when the module is active and the transport is
    ambient, as in the JAX package: its cotan weights, zeroed outside the
    module's ``keep`` mask (valid and leaflet-present triangles), fill the
    payload's w column of that leaflet, ``bending_modulus_<leaflet>`` its
    k_vec entry, and the module leaves ``rest``.  Otherwise (connection_v1's
    rotation, or the module inactive) the columns stay zero and the module,
    if active, runs per module.
    """
    from membrane_solver_tpu_torch.energy.bending_tilt_leaflet import (
        interface_divergence_mode_static,
        update_mode_static,
    )
    from membrane_solver_tpu_torch.energy.tilt_leaflet import mass_mode
    from membrane_solver_tpu_torch.energy.tilt_smoothness_leaflet import leaflet_rigidity
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
    from membrane_solver_tpu_torch.runtime.jit_core import module_scale_fn

    if dtype != torch.float32 or not set(FUSED_NAMES) <= set(e_names):
        return None
    if any(module_scale_fn(spec, name) is not None for name in e_names):
        return None
    if update_mode_static(spec, "in") != "off":
        return None
    if interface_divergence_mode_static(spec, "out") != "p1_triangle":
        return None
    if any(mass_mode(spec, leaflet) != "lumped" for leaflet in ("in", "out")):
        return None
    fr = dict(zip(e_names, e_frozen))
    bin_fr, bout_fr = fr["bending_tilt_in"], fr["bending_tilt_out"]
    if "smooth_w" in bin_fr or "smooth_w" in bout_fr:
        return None
    g = torch.where(topo.tri_valid[:, None, None], bin_fr["g"], 0.0).contiguous()
    va_in = torch.where(bin_fr["keep"][:, None], bin_fr["va_eff"], 0.0)
    va_out = torch.where(bout_fr["keep"][:, None], bout_fr["va_eff"], 0.0)
    like = va_in
    ambient = spec.option("tilt_transport_model", "ambient_v1") != "connection_v1"
    fused_names = set(FUSED_NAMES)
    w_cols, ks = {}, {}
    for leaflet in ("in", "out"):
        name = f"tilt_smoothness_{leaflet}"
        sfr = fr.get(name)
        if ambient and sfr is not None:
            w_cols[leaflet] = torch.where(sfr["keep"][:, None], sfr["weights"], 0.0)
            ks[leaflet] = leaflet_rigidity(params, leaflet, like)
            fused_names.add(name)
        else:
            w_cols[leaflet] = torch.zeros_like(va_in)
            ks[leaflet] = like.new_zeros(())
    payload = torch.cat(
        [
            fr["tilt_in"]["area"][:, None],
            fr["tilt_out"]["area"][:, None],
            bin_fr["base_c"],
            va_in,
            bout_fr["base_c"],
            va_out,
            w_cols["in"],
            w_cols["out"],
        ],
        dim=1,
    ).contiguous()
    kb = param(params, "bending_modulus", like=like)
    k_vec = torch.stack(
        [
            param(params, "tilt_modulus_in", like=like),
            param(params, "tilt_modulus_out", like=like),
            params.get("bending_modulus_in", kb),
            params.get("bending_modulus_out", kb),
            ks["in"],
            ks["out"],
        ]
    ).to(dtype)
    rest = [(fn, f) for name, fn, f in zip(e_names, e_fns, e_frozen) if name not in fused_names]
    ws = ft.Workspace(topo.tri_rows.shape[0], payload.device) if payload.is_cuda else None
    fused = FusedTiltEnergy(topo.tri_rows, topo.corner_csr(), g, payload, k_vec, ws,
                            tuple(name for name in e_names if name not in fused_names))
    return fused, rest


@dataclasses.dataclass
class FusedTiltEnergy:
    """``frozen_tilt_energy`` on one relax call's frozen inputs: fn(t_in, t_out) -> scalar.

    ``rest_names`` are the tilt modules left to the per-module path.
    """

    tri_rows: torch.Tensor
    csr: object
    g: torch.Tensor
    payload: torch.Tensor
    k_vec: torch.Tensor
    ws: object
    rest_names: tuple

    def __call__(self, t_in, t_out):
        from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

        return ft.frozen_tilt_energy(t_in, t_out, self.tri_rows, self.csr, self.g,
                                     self.payload, self.k_vec, self.ws)


@dataclasses.dataclass
class TiltRelaxStats:
    accepted_steps: int
    rejected: bool  # ended on line-search rejection
    initial_energy: float
    final_energy: float
    final_gradient_norm: float


def _host(np_dtype, *scalars):
    """One device-to-host read for several 0-dim tensors."""
    return [np_dtype(x) for x in torch.stack(scalars).tolist()]


def _backtrack(energy_of_trial, step_size, E0, np_dtype):
    """12-halving backtracking, accept if not worse (sequential form).

    ``energy_of_trial(step) -> (trial, energy tensor)``.  Returns
    (accepted, trial or None, energy of the accepted trial or E0).
    """
    step = np_dtype(step_size)
    for _bt in range(MAX_BACKTRACKS):
        trial, E1_t = energy_of_trial(float(step))
        E1 = float(E1_t)
        if E1 <= E0:
            return True, trial, E1
        step = step * np_dtype(0.5)
        if step < STEP_FLOOR:
            break
    return False, None, E0


def _converged(gnorm, tol_h) -> bool:
    return gnorm == 0.0 or (tol_h > 0.0 and gnorm < tol_h)


def make_inner_coupled_delta_cap(positions, topo, params, fixed_in):
    """The inner-coupled continuation cap on inner trial deltas: cap(delta_in) -> delta_in.

    ``inner_coupled_update_mode`` ``rim_matched_radial_continuation_v1``: rows
    in the near band (radius + lam, radius + 4 lam] about the xy center
    (``core:inner_coupled/center_xy``) clip the radial part of their delta to
    1.05x the median |radial delta| over the rim band |r - radius| <= lam;
    inactive when ``benchmark_disk_radius`` or ``benchmark_lambda_value`` is
    unset, a band is empty or the cap is not positive.  The bands depend on
    the positions only (frozen for the relax call); whether the cap is
    active stays on the device, so applying it reads nothing back.
    """
    cc = topo.extras["core:inner_coupled/center_xy"].to(positions.dtype)
    radius_b = param(params, "benchmark_disk_radius", like=positions)
    lam_b = param(params, "benchmark_lambda_value", like=positions)
    sx = positions[:, 0] + (-cc[0])
    sy = positions[:, 1] + (-cc[1])
    radii = torch.linalg.vector_norm(torch.stack([sx, sy], dim=1), dim=1)
    rgood = radii > 1e-12
    safe = torch.clamp(radii, min=1e-12)
    zero = torch.zeros_like(sx)
    rh = torch.stack([torch.where(rgood, sx / safe, 0.0), torch.where(rgood, sy / safe, 0.0),
                      zero], dim=1)
    free_in = topo.vertex_valid & ~fixed_in
    rim_m = (torch.abs(radii - radius_b) <= lam_b) & free_in
    target_m = (radii > radius_b + lam_b) & (radii <= radius_b + 4.0 * lam_b) & free_in
    active = (radius_b > 0.0) & (lam_b > 0.0) & torch.any(rim_m) & torch.any(target_m)
    n = torch.sum(rim_m.to(torch.int64))
    mid = torch.stack([torch.clamp((n - 1) // 2, min=0), torch.clamp(n // 2, min=0)])

    def masked_median_abs(vals):
        # the median over the rim band: sort with +inf padding, average the
        # two middle elements of the n live entries
        v = torch.sort(torch.where(rim_m, torch.abs(vals), torch.inf)).values
        lo_hi = v[mid]
        return torch.where(n > 0, 0.5 * (lo_hi[0] + lo_hi[1]), 0.0)

    def apply_delta_cap(delta_in):
        rad = torch.sum(delta_in * rh, dim=1)
        cap = 1.05 * masked_median_abs(rad)
        capped = torch.clamp(rad, -cap, cap)
        adjust = torch.where(target_m, capped - rad, 0.0)
        adjust = torch.where(torch.abs(adjust) > 1.0e-14, adjust, 0.0)
        out = delta_in + adjust[:, None] * rh
        return torch.where(active & (cap > 0.0), out, delta_in)

    return apply_delta_cap


def axisym_tangents(positions, normals, topo, fixed_in, fixed_out):
    """(tangent_in, tangent_out): the tangent projection, then the axisymmetric radial one.

    ``tilt_axisymmetric_about_thetaB_center``: each row keeps only the
    part of its tangent tilt along its unit radial direction about the
    theta_B axis (``core:tilt_axisym/{center,axis}``), tangent-projected;
    fixed rows keep their tangent tilt, and rows without a radial direction
    get zero.
    """
    dtype = positions.dtype
    center = topo.extras["core:tilt_axisym/center"].to(dtype)
    axis = topo.extras["core:tilt_axisym/axis"].to(dtype)
    r_vec = positions - center
    r_vec = r_vec - torch.sum(r_vec * axis, dim=1, keepdim=True) * axis
    r_len = torch.linalg.vector_norm(r_vec, dim=1)
    good0 = r_len > 1e-12
    r_hat = torch.where(good0[:, None], r_vec / torch.clamp(r_len, min=1e-12)[:, None], 0.0)
    r_dir = r_hat - torch.sum(r_hat * normals, dim=1, keepdim=True) * normals
    r_norm = torch.linalg.vector_norm(r_dir, dim=1)
    good = (good0 & (r_norm > 1e-12))[:, None]
    r_unit = torch.where(good, r_dir / torch.clamp(r_norm, min=1e-12)[:, None], 0.0)

    def axisym(t, fixed):
        t_tan = t - torch.sum(t * normals, dim=1, keepdim=True) * normals
        amp = torch.sum(t_tan * r_unit, dim=1)
        proj = torch.where(good, amp[:, None] * r_unit, 0.0)
        return torch.where(fixed, t_tan, proj)

    return (lambda t: axisym(t, fixed_in)), (lambda t: axisym(t, fixed_out))


def _uses_precond(spec: ProblemSpec, solver: str) -> bool:
    """The Jacobi preconditioner runs for CG unless ``tilt_cg_preconditioner`` is none, off or false."""
    return solver == "cg" and spec.option("tilt_cg_preconditioner", "jacobi").lower() not in {
        "none", "off", "false"}


def make_relax_leaflet_tilts(spec: ProblemSpec) -> Callable:
    """relax(state, topo, params, max_iters, step_size, tol) -> (state, TiltRelaxStats).

    ``max_iters`` is an int; ``step_size`` and ``tol`` are floats, taken in
    the state's dtype as the JAX package takes its traced scalars.  The
    options, as in the JAX package: ``tilt_cg_preconditioner`` none (CG
    without the Jacobi preconditioner), ``tilt_cg_rejection_fallback`` gd
    (a rejected CG direction is retried along steepest descent from the
    full step), ``tilt_projection_cadence`` per_pass (one constraint refresh
    after the loop in place of one after each accepted step; per_step
    refreshes every ``tilt_projection_interval``-th accepted step),
    ``tilt_axisym`` (:func:`axisym_tangents`) and ``inner_coupled_update_mode``
    (:func:`make_inner_coupled_delta_cap` on the inner trial deltas).  Each
    applies on the frozen program's path, the fused kernel's included, and
    on the per-iteration one alike.
    """
    compact_collector = make_compact_tilt_collector(spec)
    dense_rows_fn = make_tilt_constraint_rows(spec) if compact_collector is None else None
    frozen_prog = collect_frozen_tilt_program(spec)
    solver = spec.option("tilt_solver", "cg").lower()
    use_precond = _uses_precond(spec, solver)
    cadence = spec.option("tilt_projection_cadence", "per_step").lower()
    if cadence not in {"per_step", "per_pass"}:
        raise ValueError("tilt_projection_cadence must be 'per_step' or 'per_pass'.")
    cg_fallback_gd = spec.option("tilt_cg_rejection_fallback", "off").lower() == "gd"
    axisym = spec.option("tilt_axisym", "off") == "on"
    delta_cap = (spec.option("inner_coupled_update_mode", "off").strip().lower()
                 == "rim_matched_radial_continuation_v1")
    if frozen_prog is None:
        tilt_energy = make_tilt_energy(spec)
        tilt_enforce = make_tilt_enforcer(spec)

    def relax(state: MeshState, topo: Topology, params: Dict, max_iters, step_size, tol):
        dtype = state.positions.dtype
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        positions = state.positions
        geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
        normals = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())
        fixed_in = topo.tilt_fixed_in_mask[:, None]
        fixed_out = topo.tilt_fixed_out_mask[:, None]

        if axisym:
            tangent_in, tangent_out = axisym_tangents(positions, normals, topo, fixed_in,
                                                      fixed_out)
        else:
            def tangent_in(t):
                return t - torch.sum(t * normals, dim=1, keepdim=True) * normals

            tangent_out = tangent_in

        fused = None
        if frozen_prog is not None:
            e_pre, e_fns, c_pre, c_fns, e_names = frozen_prog
            e_frozen = [p(state, topo, params) for p in e_pre]
            c_frozen = [p(state, topo, params) for p in c_pre]
            fused = build_fused_tilt_energy(spec, e_names, e_fns, e_frozen, topo, params, dtype)

        if fused is not None:
            fused_fn, rest = fused

            def energy_pair(t_in, t_out):
                e = fused_fn(t_in, t_out)
                for fn, f in rest:
                    e = e + fn(t_in, t_out, f, topo, params)
                return e

        elif frozen_prog is not None:

            def energy_pair(t_in, t_out):
                # one shared corner gather per leaflet feeds every module
                ctx = {"tin_c": t_in[topo.tri_rows], "tout_c": t_out[topo.tri_rows]}
                e = t_in.new_zeros(())
                for fn, f in zip(e_fns, e_frozen):
                    e = e + fn(t_in, t_out, f, topo, params, ctx)
                return e

        else:

            def energy_pair(t_in, t_out):
                return tilt_energy(
                    dataclasses.replace(state, tilts_in=t_in, tilts_out=t_out), topo, params
                )

        if frozen_prog is not None:

            def enforce_pair(t_in, t_out):
                for fn, f in zip(c_fns, c_frozen):
                    t_in, t_out = fn(t_in, t_out, f, topo, params)
                return t_in, t_out

        else:

            def enforce_pair(t_in, t_out):
                st = tilt_enforce(
                    dataclasses.replace(state, tilts_in=t_in, tilts_out=t_out), topo, params
                )
                return st.tilts_in, st.tilts_out

        def refresh_pair(t_in, t_out):
            t_in, t_out = enforce_pair(t_in, t_out)
            return tangent_in(t_in), tangent_out(t_out)

        # 1. enforce tilt constraints + tangent-project
        tin, tout = refresh_pair(state.tilts_in, state.tilts_out)
        fixed_vals_in, fixed_vals_out = tin, tout

        # the constraint rows depend on positions only: factor once
        if compact_collector is not None:
            projector = make_compact_tilt_projector(
                compact_collector(state, topo, params), positions.shape[0])
        else:
            projector = make_tilt_projector(dense_rows_fn(state, topo, params))
        cap = (make_inner_coupled_delta_cap(positions, topo, params, topo.tilt_fixed_in_mask)
               if delta_cap and "core:inner_coupled/center_xy" in topo.extras else None)

        def eval_grads(t_in, t_out):
            """(E, gin, gout, gnorm) with the projected, fixed-row-zeroed gradients."""
            a = t_in.detach().requires_grad_(True)
            b = t_out.detach().requires_grad_(True)
            with torch.enable_grad():
                E = energy_pair(a, b)
                gin, gout = torch.autograd.grad(E, (a, b))
            gin, gout = projector(gin, gout)
            gin = torch.where(fixed_in, 0.0, gin)
            gout = torch.where(fixed_out, 0.0, gout)
            gnorm = torch.sqrt(torch.sum(gin * gin) + torch.sum(gout * gout))
            return E.detach(), gin, gout, gnorm

        def backtrack(dir_in, dir_out, E0):
            """The trial from (tin, tout) along the direction, or (tin, tout) on rejection."""

            def trial_at(step):
                delta_in = step * dir_in
                if cap is not None:
                    delta_in = cap(delta_in)
                trial_in = torch.where(fixed_in, fixed_vals_in, tangent_in(tin + delta_in))
                trial_out = torch.where(fixed_out, fixed_vals_out,
                                        tangent_out(tout + step * dir_out))
                return (trial_in, trial_out), energy_pair(trial_in, trial_out)

            accepted, trial, E1 = _backtrack(trial_at, step_size, E0, np_dtype)
            return (accepted, *(trial if accepted else (tin, tout)), E1)

        def refresh(new_in, new_out, nacc):
            """The per-step constraint refresh + tangent projection, at its interval."""
            if cadence == "per_step" and nacc % proj_interval == 0:
                return refresh_pair(new_in, new_out)
            return new_in, new_out

        interval = params.get("tilt_projection_interval")
        proj_interval = max(int(interval.item()) if interval is not None else 1, 1)
        tol_h = np_dtype(tol)
        nacc = 0
        rejected = False

        if solver == "gd":
            # the JAX package reports no initial energy for GD
            E_first = E_last = gnorm = np_dtype(0.0)
            for _i in range(int(max_iters)):
                E0_t, gin, gout, gnorm_t = eval_grads(tin, tout)
                E0, gnorm = _host(np_dtype, E0_t, gnorm_t)
                if _converged(gnorm, tol_h):
                    E_last = E0
                    break
                accepted, new_in, new_out, E_last = backtrack(-gin, -gout, E0)
                if not accepted:
                    rejected = True
                    break
                nacc += 1
                tin, tout = refresh(new_in, new_out, nacc)
        else:
            if use_precond:
                m_in, m_out = jacobi_preconditioner(positions, topo, params)
                m_in, m_out = m_in[:, None], m_out[:, None]

            def precondition(r_in, r_out):
                return (r_in * m_in, r_out * m_out) if use_precond else (r_in, r_out)

            monotone = dtype != torch.float64
            E0_t, gin, gout, gnorm_t = eval_grads(tin, tout)
            r_in, r_out = -gin, -gout
            z_in, z_out = precondition(r_in, r_out)
            d_in, d_out = z_in, z_out
            rz_old = torch.sum(r_in * z_in) + torch.sum(r_out * z_out)
            E0, gnorm, rz_old_h = _host(np_dtype, E0_t, gnorm_t, rz_old)
            E_first = E0
            best_in, best_out, best_E = tin, tout, E0
            for _i in range(int(max_iters)):
                if _converged(gnorm, tol_h):
                    break
                accepted, new_in, new_out, _E1 = backtrack(d_in, d_out, E0)
                if not accepted and cg_fallback_gd:
                    # retry the rejected CG direction along steepest descent
                    accepted, new_in, new_out, _E1 = backtrack(-gin, -gout, E0)
                if not accepted:
                    rejected = True
                    break
                nacc += 1
                new_in, new_out = refresh(new_in, new_out, nacc)
                E2_t, gin, gout, gnorm2_t = eval_grads(new_in, new_out)
                r_in, r_out = -gin, -gout
                z_in, z_out = precondition(r_in, r_out)
                rz_new = torch.sum(r_in * z_in) + torch.sum(r_out * z_out)
                E2, gnorm2, rz_new_h = _host(np_dtype, E2_t, gnorm2_t, rz_new)
                tin, tout, E0, gnorm = new_in, new_out, E2, gnorm2
                if E2 < best_E:
                    best_in, best_out, best_E = new_in, new_out, E2
                if rz_old_h == 0.0:
                    break
                beta = rz_new / rz_old
                d_in, d_out = z_in + beta * d_in, z_out + beta * d_out
                rz_old, rz_old_h = rz_new, rz_new_h
            E_last = E0
            if monotone and best_E < E_last:
                # f32: revert to the best accepted state when the CG walked uphill
                tin, tout, E_last = best_in, best_out, best_E
        if cadence == "per_pass":
            # one refresh for the whole pass, unconditionally
            tin, tout = refresh_pair(tin, tout)

        out_state = dataclasses.replace(state, tilts_in=tin, tilts_out=tout)
        stats = TiltRelaxStats(
            accepted_steps=nacc,
            rejected=rejected,
            initial_energy=float(E_first),
            final_energy=float(E_last),
            final_gradient_norm=float(gnorm),
        )
        if RELAX_RECORD is not None:
            RELAX_RECORD.append(nacc)
        return out_state, stats

    return relax


def make_relax_vertex_tilts(spec: ProblemSpec) -> Callable:
    """relax(state, topo, params, max_iters, step_size, tol) -> (state, accepted steps).

    The single-field relax (JAX ``make_relax_vertex_tilts``): CG with the
    Jacobi preconditioner (its inner-leaflet diagonal, as in the JAX
    package; none with ``tilt_cg_preconditioner`` none) or GD on
    ``state.tilts`` with positions frozen: tangent
    projection per trial, fixed-row clamping, 12-halving
    accept-if-not-worse backtracking, convergence on the gradient norm.  No
    single-field constraint module has tilt rows, so no KKT projection and
    no constraint refresh run here.
    """
    tilt_energy = make_tilt_energy(spec)
    solver = spec.option("tilt_solver", "cg").lower()
    use_precond = _uses_precond(spec, solver)

    def relax(state: MeshState, topo: Topology, params: Dict, max_iters, step_size, tol):
        dtype = state.positions.dtype
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        positions = state.positions
        geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
        normals = dgeo.vertex_normals(geo, topo.tri_valid, topo.corner_csr())
        fixed = topo.tilt_fixed_mask[:, None]

        def tangent(t):
            return t - torch.sum(t * normals, dim=1, keepdim=True) * normals

        def energy_of(t):
            return tilt_energy(dataclasses.replace(state, tilts=t), topo, params)

        t = tangent(state.tilts)
        fixed_vals = t

        def eval_grads(tilts):
            a = tilts.detach().requires_grad_(True)
            with torch.enable_grad():
                E = energy_of(a)
                (g,) = torch.autograd.grad(E, (a,))
            g = torch.where(fixed, 0.0, g)
            return E.detach(), g, torch.linalg.vector_norm(g)

        def backtrack(direction, E0):
            def trial_at(step):
                trial = torch.where(fixed, fixed_vals, tangent(t + step * direction))
                return trial, energy_of(trial)

            accepted, trial, _E1 = _backtrack(trial_at, step_size, E0, np_dtype)
            return accepted, trial

        tol_h = np_dtype(tol)
        nacc = 0
        if solver == "gd":
            for _i in range(int(max_iters)):
                E0_t, g, gnorm_t = eval_grads(t)
                E0, gnorm = _host(np_dtype, E0_t, gnorm_t)
                if _converged(gnorm, tol_h):
                    break
                accepted, new_t = backtrack(-g, E0)
                if not accepted:
                    break
                t, nacc = new_t, nacc + 1
        else:
            m = jacobi_preconditioner(positions, topo, params)[0][:, None] if use_precond else None
            E0_t, g, gnorm_t = eval_grads(t)
            r = -g
            z = r if m is None else r * m
            d = z
            rz_old = torch.sum(r * z)
            E0, gnorm, rz_old_h = _host(np_dtype, E0_t, gnorm_t, rz_old)
            for _i in range(int(max_iters)):
                if _converged(gnorm, tol_h):
                    break
                accepted, new_t = backtrack(d, E0)
                if not accepted:
                    break
                nacc += 1
                E2_t, g, gnorm2_t = eval_grads(new_t)
                r = -g
                z = r if m is None else r * m
                rz_new = torch.sum(r * z)
                E2, gnorm2, rz_new_h = _host(np_dtype, E2_t, gnorm2_t, rz_new)
                t, E0, gnorm = new_t, E2, gnorm2
                if rz_old_h == 0.0:
                    break
                d = z + (rz_new / rz_old) * d
                rz_old, rz_old_h = rz_new, rz_new_h
        return dataclasses.replace(state, tilts=t), nacc

    return relax
