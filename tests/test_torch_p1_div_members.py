"""Kernel 4's member forms and its g-less entry on the CPU, against the JAX package.

- ``tri_kernels.p1_divergence_members_reference`` (the CPU path and the
  card's oracle of ``tri_p1_div_members``) at B = 1, 3 and 9 members, every
  input per member, the positions shared or the tilts shared (one (Nv, 3)
  array, as the member launch takes it; with shared positions the area and
  g come back as one member's), held member by member against the JAX
  package's ``p1_divergence_pallas`` in interpret mode (the JAX kernel
  tests' CPU route) at float32 with that file's tolerances (rel 5e-5, atol
  1e-5), and against ``tilt_ops.p1_triangle_divergence`` under
  ``jax.vmap`` at float64 (1e-12).
- ``tri_kernels.p1_divergence_and_area``, the entry of the callers that drop
  the shape gradients (the bending-tilt energy, the face values), on the
  kozlov lane at L0, L1 and L2: the same div and area as
  ``p1_triangle_divergence``, alone and under ``torch.func.vmap`` in each
  member form; where the tilts require grad, its tilt gradient is the full
  entry's bits and within 1e-12 of ``jax.vjp`` (no gradient dropped); and a
  call that writes no g while the tilts take a gradient raises.

The member launch against single launches, bit for bit, is card-only:
``tests/test_torch_p1_div_members_card.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_harness import assert_close, make_minimizer

from membrane_solver_tpu.device import tilt_ops as jtops
from membrane_solver_tpu.pallas_kernels import p1_divergence_pallas
from membrane_solver_tpu_torch.device.state import corner_csr
from membrane_solver_tpu_torch.kernels import tri_kernels as tk

T, NV = 200, 90
F64_RTOL = 1e-12
EPS_AREA = 1e-12  # geo.EPS_AREA: the area mask's floor
FORMS = ("per_member", "positions_shared", "tilts_shared")


def _inputs(B: int, form: str, dtype, seed: int = 11):
    """The JAX kernel tests' triangles (the last 7 invalid) and B members' positions and tilts
    (member m's the seeded ones scaled by 1 + 0.01 m, resp. 1 - 0.01 m, and jittered); a
    shared input one (Nv, 3) array."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, NV, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (NV - 2)) % NV
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (NV - 2)) % NV
    base_p, base_t = rng.standard_normal((NV, 3)), 0.3 * rng.standard_normal((NV, 3))
    pos = np.stack([base_p * (1 + 0.01 * m) + 1e-3 * rng.standard_normal((NV, 3))
                    for m in range(B)]).astype(dtype)
    tilts = np.stack([base_t * (1 - 0.01 * m) + 1e-3 * rng.standard_normal((NV, 3))
                      for m in range(B)]).astype(dtype)
    valid = np.ones(T, dtype=bool)
    valid[-7:] = False
    return (pos[0] if form == "positions_shared" else pos,
            tilts[0] if form == "tilts_shared" else tilts, rows, valid)


def _member(x, m: int):
    return x if x.ndim == 2 else x[m]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("B", [1, 3, 9])
def test_member_twin_matches_pallas_per_member_f32(B, form):
    pos, tilts, rows, valid = _inputs(B, form, np.float32)
    div, area, g = tk.p1_divergence_members_reference(
        torch.as_tensor(pos), torch.as_tensor(tilts), torch.as_tensor(rows),
        torch.as_tensor(valid))
    assert div.shape == (B, T)
    assert area.shape == ((T,) if form == "positions_shared" else (B, T))
    assert g.shape == area.shape + (3, 3)
    for m in range(B):
        p, t = _member(pos, m), _member(tilts, m)
        want = p1_divergence_pallas(*(jnp.asarray(p[rows[:, k]]) for k in range(3)),
                                    *(jnp.asarray(t[rows[:, k]]) for k in range(3)))
        w_div, w_area = np.asarray(want[0]), np.asarray(want[1])
        w_div = np.where(valid, w_div, 0.0)
        w_area = np.where(valid & (2 * w_area >= EPS_AREA), w_area, 0.0)
        w_g = np.stack([np.asarray(x) for x in want[2:]], axis=1)
        one = form == "positions_shared"  # the area and g: one member's
        for got, w, name in ((div[m], w_div, "div"), (area if one else area[m], w_area, "area"),
                             (g if one else g[m], w_g, "g")):
            np.testing.assert_allclose(got.numpy(), w, rtol=5e-5, atol=1e-5,
                                       err_msg=f"{name} member {m}")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("B", [1, 3, 9])
def test_member_twin_matches_jax_vmap_f64(B, form):
    pos, tilts, rows, valid = _inputs(B, form, np.float64)
    in_axes = (None if form == "positions_shared" else 0, None if form == "tilts_shared" else 0)
    want = jax.vmap(functools.partial(jtops.p1_triangle_divergence,
                                      tri_rows=jnp.asarray(rows, jnp.int32),
                                      tri_valid=jnp.asarray(valid)),
                    in_axes=in_axes)(jnp.asarray(pos), jnp.asarray(tilts))
    got = tk.p1_divergence_members_reference(torch.as_tensor(pos), torch.as_tensor(tilts),
                                             torch.as_tensor(rows), torch.as_tensor(valid))
    for m in range(B):
        for x, w, name in zip(got, want, ("div", "area", "g")):
            got_m = x[m] if name == "div" or form != "positions_shared" else x
            assert_close(got_m, np.asarray(w[m]), F64_RTOL, f"{name} member {m}", atol_scale=1.0)


@functools.lru_cache(maxsize=None)
def _lane(refines: int):
    """(positions, tri_rows, tri_valid, csr, seeded tilts) of the kozlov lane at L<refines>."""
    topo_state = make_minimizer(True, refines=refines, dtype=torch.float64).problem()
    pos = topo_state.state.positions.detach()
    rng = np.random.default_rng(refines)
    tilts = torch.as_tensor(0.3 * rng.standard_normal(tuple(pos.shape)))
    topo = topo_state.topo
    return pos, topo.tri_rows, topo.tri_valid, topo.corner_csr(), tilts


def _forms_inputs(form: str, pos, tilts, B: int = 3):
    """The members of ``form``: (positions, tilts, in_dims) for torch.func.vmap; single: one
    each."""
    if form == "single":
        return pos, tilts, None
    P = torch.stack([pos * (1 + 1e-3 * m) for m in range(B)])
    Tl = torch.stack([tilts * (1 - 0.01 * m) for m in range(B)])
    p = pos if form == "positions_shared" else P
    t = tilts if form == "tilts_shared" else Tl
    return p, t, (None if p.dim() == 2 else 0, None if t.dim() == 2 else 0)


def _call(fn, p, t, rows, valid, csr, in_dims):
    if in_dims is None:
        return fn(p, t, rows, valid, csr)
    return torch.func.vmap(lambda x, y: fn(x, y, rows, valid, csr), in_dims=in_dims)(p, t)


@pytest.mark.parametrize("form", ("single",) + FORMS)
@pytest.mark.parametrize("refines", [0, 1, 2], ids=["L0", "L1", "L2"])
def test_g_less_entry_gives_the_full_entrys_div_and_area(refines, form):
    pos, rows, valid, csr, tilts = _lane(refines)
    p, t, in_dims = _forms_inputs(form, pos, tilts)
    div, area = _call(tk.p1_divergence_and_area, p, t, rows, valid, csr, in_dims)
    want = _call(tk.p1_triangle_divergence, p, t, rows, valid, csr, in_dims)
    assert torch.equal(div, want[0]) and torch.equal(area, want[1])


@pytest.mark.parametrize("form", ("single",) + FORMS)
@pytest.mark.parametrize("refines", [0, 1, 2], ids=["L0", "L1", "L2"])
def test_g_less_entry_keeps_the_tilt_gradient_f64(refines, form):
    """With the tilts requiring grad the g-less entry writes g and keeps it: its tilt gradient
    is the full entry's bits and JAX's ``jax.vjp`` to 1e-12."""
    pos, rows, valid, csr, tilts = _lane(refines)
    p, t, in_dims = _forms_inputs(form, pos, tilts)
    n_tri = rows.shape[0]
    ct = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (n_tri,) if in_dims is None else (3, n_tri)))
    grads = []
    for fn in (tk.p1_divergence_and_area, tk.p1_triangle_divergence):
        a = t.detach().clone().requires_grad_(True)
        div = _call(fn, p, a, rows, valid, csr, in_dims)[0]
        grads.append(torch.autograd.grad(div, (a,), (ct,))[0])
    assert torch.equal(grads[0], grads[1])

    j_rows, j_valid = jnp.asarray(rows.numpy(), jnp.int32), jnp.asarray(valid.numpy())

    def jax_div(x, y):
        return jtops.p1_triangle_divergence(x, y, j_rows, j_valid)[0]

    fn = jax_div if in_dims is None else jax.vmap(jax_div, in_axes=in_dims)
    _div, vjp = jax.vjp(lambda y: fn(jnp.asarray(p.numpy()), y), jnp.asarray(t.numpy()))
    (want,) = vjp(jnp.asarray(ct.numpy()))
    assert_close(grads[0], np.asarray(want), F64_RTOL, "tilt gradient", atol_scale=1.0)


@pytest.mark.parametrize("form", ("single",) + FORMS)
def test_a_call_told_to_drop_g_keeps_or_refuses_a_tilt_gradient(form):
    """A single call told to write no g while autograd follows the tilts raises (a dropped
    gradient is a fault, not a saving); the member launch decides from the tilts' own
    ``needs_input_grad`` and writes g, so its gradient is the full entry's bits."""
    pos, rows, valid, csr, tilts = _lane(0)
    p, t, in_dims = _forms_inputs(form, pos, tilts)

    def no_g(x, y, rows, valid, csr):
        return tk._p1_divergence(x, y, rows, valid, csr, False)[:2]

    grads = []
    for fn in (no_g, tk.p1_triangle_divergence):
        a = t.detach().clone().requires_grad_(True)
        if fn is no_g and in_dims is None:
            with pytest.raises(RuntimeError, match="no shape gradients"):
                _call(fn, p, a, rows, valid, csr, in_dims)
            return
        div = _call(fn, p, a, rows, valid, csr, in_dims)[0]
        grads.append(torch.autograd.grad(div.sum(), (a,))[0])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("B", [1, 3, 9])
def test_member_tilt_backward_twin_takes_a_shared_g(B):
    """The member tilt backward's twin on one (T, 3, 3) g shared by the members (the forward's
    with shared positions) is its twin on B copies, bit for bit, and each member's single twin."""
    pos, _tilts, rows, valid = _inputs(1, "per_member", np.float64)
    t_rows, v = torch.as_tensor(rows), torch.as_tensor(valid)
    csr = corner_csr(t_rows, NV)
    g = tk.p1_divergence_members_reference(torch.as_tensor(pos), torch.as_tensor(_tilts), t_rows,
                                           v)[2][0]
    ct = torch.as_tensor(np.random.default_rng(B).standard_normal((B, T)))
    got = tk.p1_div_vjp_members_reference(g, v, ct, csr)
    assert torch.equal(got, tk.p1_div_vjp_members_reference(g.expand(B, T, 3, 3), v, ct, csr))
    for m in range(B):
        assert torch.equal(got[m], tk.p1_div_vjp_reference(g, v, ct[m], csr))
