"""Tilt relaxation (the inner solves), positions frozen.

Counterpart of ``membrane_solver_tpu/runtime/tilt_relax.py``.
``make_relax_leaflet_tilts`` relaxes both leaflet fields:

1. enforce the tilt constraints and tangent-project both leaflet fields;
2. evaluate the tilt energy and its gradient for both leaflets, project
   the gradient against the compact tilt-constraint rows (KKT, factored
   once per call), zero the fixed rows;
3. CG (Jacobi-preconditioned, beta = rz_new / rz_old) or GD, each with
   12-halving backtracking accept-if-not-worse on tangent-projected trials
   with fixed-row overrides and a constraint refresh after each accepted
   step;
4. stop on zero gradient, tol convergence, rejection or max iters.

``make_relax_vertex_tilts`` runs the same CG or GD on the single ``tilts``
field, with no constraint rows and no refresh.

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
    from membrane_solver_tpu_torch.runtime.jit_core import active_energy_modules

    fns = []
    for name in active_energy_modules(spec):
        module = get_module(name)
        if not _uses_tilts(module):
            continue
        maker = getattr(module, "make_inloop_energy", None) or getattr(module, "make_energy", None)
        fns.append(maker(spec) if maker is not None else module.energy)

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


def make_compact_tilt_collector(spec: ProblemSpec):
    """Collect the modules' compact tilt rows into one slot table.

    Returns collect(state, topo, params) -> (values (k, s, 3), rows (k, s),
    leaflet (k, s), backgrounds) or None when no module has tilt rows; a
    module block of fewer slots is zero-padded.  Each background is a
    rank-1 term (coefficients (k,), field (2, Nv, 3)).
    """
    from membrane_solver_tpu_torch.constraints import get_constraint

    builders = []
    for name in dict.fromkeys(spec.constraint_modules):
        maker = getattr(get_constraint(name), "make_compact_tilt_rows", None)
        if maker is not None:
            builders.append(maker(spec))
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
    from membrane_solver_tpu_torch.runtime.jit_core import active_energy_modules

    e_pre, e_fns, e_names = [], [], []
    for name in active_energy_modules(spec):
        module = get_module(name)
        if not _uses_tilts(module):
            continue
        hook = getattr(module, "make_tilt_frozen", None)
        if hook is None:
            return None
        pre, fn = hook(spec)
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


def build_fused_tilt_energy(e_names, e_fns, e_frozen, topo, params, dtype):
    """The fused frozen-tilt energy, or None if ineligible.

    Eligible at float32 when all four triangle tilt modules are active (the
    port runs them with lumped mass and default bending-tilt modes only).
    Returns ``(fused_fn(t_in, t_out) -> scalar, rest)`` on vertex tilts, with
    ``rest`` the remaining (fn, frozen) pairs evaluated per module (none of
    them reads the shared corner gather, which the fused path no longer
    makes).  The entry point's scratch is allocated here, once per relax
    call.  Validity masks are
    folded into the payload: A and va are zero wherever the per-module path
    masks the term, and g is zero on invalid triangles.  The tilt-smoothness
    columns of the payload stay zero: those modules are not ported.
    """
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

    if dtype != torch.float32 or not set(FUSED_NAMES) <= set(e_names):
        return None
    fr = dict(zip(e_names, e_frozen))
    bin_fr, bout_fr = fr["bending_tilt_in"], fr["bending_tilt_out"]
    g = torch.where(topo.tri_valid[:, None, None], bin_fr["g"], 0.0).contiguous()
    va_in = torch.where(bin_fr["keep"][:, None], bin_fr["va_eff"], 0.0)
    va_out = torch.where(bout_fr["keep"][:, None], bout_fr["va_eff"], 0.0)
    zeros3 = torch.zeros_like(va_in)
    payload = torch.cat(
        [
            fr["tilt_in"]["area"][:, None],
            fr["tilt_out"]["area"][:, None],
            bin_fr["base_c"],
            va_in,
            bout_fr["base_c"],
            va_out,
            zeros3,
            zeros3,
        ],
        dim=1,
    ).contiguous()
    like = payload
    kb = param(params, "bending_modulus", like=like)
    zero = like.new_zeros(())
    k_vec = torch.stack(
        [
            param(params, "tilt_modulus_in", like=like),
            param(params, "tilt_modulus_out", like=like),
            params.get("bending_modulus_in", kb),
            params.get("bending_modulus_out", kb),
            zero,
            zero,
        ]
    ).to(dtype)
    rest = [(fn, f) for name, fn, f in zip(e_names, e_fns, e_frozen) if name not in FUSED_NAMES]
    csr = topo.corner_csr()
    ws = ft.Workspace(topo.tri_rows.shape[0], payload.device) if payload.is_cuda else None

    def fused_fn(t_in, t_out):
        return ft.frozen_tilt_energy(t_in, t_out, topo.tri_rows, csr, g, payload, k_vec, ws)

    return fused_fn, rest


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


def make_relax_leaflet_tilts(spec: ProblemSpec) -> Callable:
    """relax(state, topo, params, max_iters, step_size, tol) -> (state, TiltRelaxStats).

    ``max_iters`` is an int; ``step_size`` and ``tol`` are floats, taken in
    the state's dtype as the JAX package takes its traced scalars.
    """
    compact_collector = make_compact_tilt_collector(spec)
    frozen_prog = collect_frozen_tilt_program(spec)
    solver = spec.option("tilt_solver", "cg").lower()
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

        def tangent(t):
            return t - torch.sum(t * normals, dim=1, keepdim=True) * normals

        fused = None
        if frozen_prog is not None:
            e_pre, e_fns, c_pre, c_fns, e_names = frozen_prog
            e_frozen = [p(state, topo, params) for p in e_pre]
            c_frozen = [p(state, topo, params) for p in c_pre]
            fused = build_fused_tilt_energy(e_names, e_fns, e_frozen, topo, params, dtype)

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

        # 1. enforce tilt constraints + tangent-project
        tin, tout = enforce_pair(state.tilts_in, state.tilts_out)
        tin = tangent(tin)
        tout = tangent(tout)
        fixed_vals_in, fixed_vals_out = tin, tout

        # the constraint rows depend on positions only: factor once
        projector = make_compact_tilt_projector(
            compact_collector(state, topo, params) if compact_collector else None,
            positions.shape[0],
        )

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
                trial_in = torch.where(fixed_in, fixed_vals_in, tangent(tin + step * dir_in))
                trial_out = torch.where(fixed_out, fixed_vals_out, tangent(tout + step * dir_out))
                return (trial_in, trial_out), energy_pair(trial_in, trial_out)

            accepted, trial, E1 = _backtrack(trial_at, step_size, E0, np_dtype)
            return (accepted, *(trial if accepted else (tin, tout)), E1)

        def refresh(new_in, new_out, nacc):
            """The per-accepted-step constraint refresh + tangent projection, at its interval."""
            if nacc % proj_interval == 0:
                new_in, new_out = enforce_pair(new_in, new_out)
                new_in, new_out = tangent(new_in), tangent(new_out)
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
            m_in, m_out = jacobi_preconditioner(positions, topo, params)
            m_in, m_out = m_in[:, None], m_out[:, None]
            monotone = dtype != torch.float64
            E0_t, gin, gout, gnorm_t = eval_grads(tin, tout)
            r_in, r_out = -gin, -gout
            z_in, z_out = r_in * m_in, r_out * m_out
            d_in, d_out = z_in, z_out
            rz_old = torch.sum(r_in * z_in) + torch.sum(r_out * z_out)
            E0, gnorm, rz_old_h = _host(np_dtype, E0_t, gnorm_t, rz_old)
            E_first = E0
            best_in, best_out, best_E = tin, tout, E0
            for _i in range(int(max_iters)):
                if _converged(gnorm, tol_h):
                    break
                accepted, new_in, new_out, _E1 = backtrack(d_in, d_out, E0)
                if not accepted:
                    rejected = True
                    break
                nacc += 1
                new_in, new_out = refresh(new_in, new_out, nacc)
                E2_t, gin, gout, gnorm2_t = eval_grads(new_in, new_out)
                r_in, r_out = -gin, -gout
                z_in, z_out = r_in * m_in, r_out * m_out
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

        out_state = dataclasses.replace(state, tilts_in=tin, tilts_out=tout)
        stats = TiltRelaxStats(
            accepted_steps=nacc,
            rejected=rejected,
            initial_energy=float(E_first),
            final_energy=float(E_last),
            final_gradient_norm=float(gnorm),
        )
        return out_state, stats

    return relax


def make_relax_vertex_tilts(spec: ProblemSpec) -> Callable:
    """relax(state, topo, params, max_iters, step_size, tol) -> (state, accepted steps).

    The single-field relax (JAX ``make_relax_vertex_tilts``): CG with the
    Jacobi preconditioner (its inner-leaflet diagonal, as in the JAX
    package) or GD on ``state.tilts`` with positions frozen: tangent
    projection per trial, fixed-row clamping, 12-halving
    accept-if-not-worse backtracking, convergence on the gradient norm.  No
    single-field constraint module has tilt rows, so no KKT projection and
    no constraint refresh run here.
    """
    tilt_energy = make_tilt_energy(spec)
    solver = spec.option("tilt_solver", "cg").lower()

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
            m = jacobi_preconditioner(positions, topo, params)[0][:, None]
            E0_t, g, gnorm_t = eval_grads(t)
            r = -g
            z = r * m
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
                z = r * m
                rz_new = torch.sum(r * z)
                E2, gnorm2, rz_new_h = _host(np_dtype, E2_t, gnorm2_t, rz_new)
                t, E0, gnorm = new_t, E2, gnorm2
                if rz_old_h == 0.0:
                    break
                d = z + (rz_new / rz_old) * d
                rz_old, rz_old_h = rz_new, rz_new_h
        return dataclasses.replace(state, tilts=t), nacc

    return relax
