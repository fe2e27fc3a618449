"""Card only: kernel 4's grouped member launch and its tilt backward against single launches, bit for bit.

``tri_p1_div_members`` runs a group of members in each block over one
128-triangle tile; member m of a B-member call must be the bits of
``tri_p1_div`` on member m alone: div, the area and, where written, g.  For
every group the library takes and B = 1, 2, the group less one, the group,
one more (a partial last group), 8, 9 and 72; every input per member, the
positions shared or the tilts shared (one (Nv, 3) array); with and without
g; float32 and float64; on random triangles (T = 301: a member's g slab off
a 16-byte boundary; T = 21,504, the kozlov L3 count, with an out-of-range
row: NaN outputs).  The weighted tilt backward ``tri_p1_div_bwd_members``
the same way, on per-member g and on one g shared by the members, at every
group it takes.  The g-less entry keeps the tilt gradient where the tilts
require grad.  Skips where there is no CUDA device.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from membrane_solver_tpu_torch.device.state import corner_csr
from membrane_solver_tpu_torch.kernels import tri_kernels as tk


def _widths(group: int) -> list:
    return sorted({1, 2, group - 1, group, group + 1, 8, 9, 72} - {0})


def _mesh(T: int, rng, bad_row: bool):
    nv = T // 2 + 9
    rows = rng.integers(0, nv, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (nv - 2)) % nv
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (nv - 2)) % nv
    if bad_row:
        rows[T // 3, 1] = nv + 5  # out of range: that triangle's outputs are NaN
    return rows, nv


def _same(got, want) -> bool:
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.view(ints[got.dtype]), want.view(ints[want.dtype])))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("T", [301, 21504])
def test_member_launch_is_single_launches_bits(T, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(T)
    rows_np, nv = _mesh(T, rng, bad_row=T > 301)
    rows = torch.as_tensor(rows_np, device="cuda")
    valid = torch.as_tensor(rng.uniform(size=T) > 0.05, device="cuda")
    max_group = tk.build().tri_p1_div_max_group()

    def f(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")

    for group in range(1, max_group + 1):
        for B in _widths(group):
            pos, tilts = f(B, nv, 3), f(B, nv, 3)
            for form in ("per member", "positions shared", "tilts shared"):
                p = pos[0].contiguous() if form == "positions shared" else pos
                t = tilts[0].contiguous() if form == "tilts shared" else tilts
                for grads in (True, False):
                    div, area, g = tk.launch_p1_divergence_members(p, t, rows, valid, grads,
                                                                   group=group)
                    assert (g is None) == (not grads)
                    for m in range(B):
                        p_m = p if p.dim() == 2 else p[m].contiguous()
                        t_m = t if t.dim() == 2 else t[m].contiguous()
                        d1, a1, g1 = tk.launch_p1_divergence(p_m, t_m, rows, valid)
                        what = (group, B, form, grads, m)
                        assert _same(div[m], d1), what
                        if form == "positions shared":
                            assert _same(area, a1) and (g is None or _same(g, g1)), what
                        else:
                            assert _same(area[m], a1) and (g is None or _same(g[m], g1)), what
                        if m == 0:  # the single call without g: the same div and area
                            d0, a0, g0 = tk.launch_p1_divergence(p_m, t_m, rows, valid,
                                                                 grads=False)
                            assert g0 is None and _same(d0, d1) and _same(a0, a1), what
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("T", [301, 21504])
def test_member_tilt_backward_is_single_launches_bits(T, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(T + 1)
    rows_np, nv = _mesh(T, rng, bad_row=False)
    rows = torch.as_tensor(rows_np, device="cuda")
    valid = torch.as_tensor(rng.uniform(size=T) > 0.2, device="cuda")
    csr = corner_csr(rows, nv)
    max_group = tk.build().tri_p1_div_bwd_max_group()
    for group in range(1, max_group + 1):
        for B in _widths(group):
            gs = torch.as_tensor(rng.standard_normal((B, T, 3, 3)), dtype=dtype, device="cuda")
            w = torch.as_tensor(rng.standard_normal((B, T)), dtype=dtype, device="cuda")
            for shared in (False, True):
                g = gs[0].contiguous() if shared else gs
                got = tk.launch_p1_div_bwd_members(g, valid, w, csr, group=group)
                for m in range(B):
                    want = tk.launch_p1_div_bwd(g if shared else g[m].contiguous(), valid,
                                                w[m].contiguous(), csr)
                    assert _same(got[m], want), (group, B, shared, m)
    with pytest.raises(RuntimeError, match="cudaError"):
        tk.launch_p1_div_bwd_members(gs, valid, w, csr, group=max_group + 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_g_less_entry_keeps_the_tilt_gradient(dtype):
    """The g-less entry with tilts that require grad: the full entry's tilt gradient in bits,
    alone and under ``torch.func.vmap`` with the positions or the tilts shared."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(5)
    rows_np, nv = _mesh(21504, rng, bad_row=False)
    rows = torch.as_tensor(rows_np, device="cuda")
    valid = torch.as_tensor(rng.uniform(size=rows.shape[0]) > 0.05, device="cuda")
    csr = corner_csr(rows, nv)

    def f(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")

    cases = [(f(nv, 3), f(nv, 3), None), (f(3, nv, 3), f(3, nv, 3), (0, 0)),
             (f(nv, 3), f(3, nv, 3), (None, 0)), (f(3, nv, 3), f(nv, 3), (0, None))]
    for p, t, in_dims in cases:
        ct = f(*((rows.shape[0],) if in_dims is None else (3, rows.shape[0])))
        grads = []
        for fn in (tk.p1_divergence_and_area, tk.p1_triangle_divergence):
            a = t.clone().requires_grad_(True)
            if in_dims is None:
                div = fn(p, a, rows, valid, csr)[0]
            else:
                div = torch.func.vmap(lambda x, y, fn=fn: fn(x, y, rows, valid, csr)[0],
                                      in_dims=in_dims)(p, a)
            grads.append(torch.autograd.grad(div, (a,), (ct,))[0])
        assert _same(grads[0], grads[1]), in_dims
    torch.cuda.synchronize()
