"""The frozen-tilt entry point's plain twins and wrapper against the JAX package.

On the CPU the entry point (``frozen_tilt_energy`` on vertex tilts) runs
its twin, ``reference_vertex``: the corner gather, ``reference_energy`` /
``reference_grads`` and the corner-CSR vertex sum.  The twins must match
the JAX package's oracle and its Pallas kernel in interpret mode at
float32, T = 301: energy to rel 1e-6, gradient to 5e-6 * max|g| (the JAX
kernel tests' bounds), the vertex gradient against ``jax.grad`` with
respect to the vertex tilts of the Pallas kernel on gathered corners.  The
CUDA kernels themselves are checked against the twins by ``chip_smoke.py``
on the card, and by the CUDA-only test here where CUDA and JAX are both
present.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from membrane_solver_tpu.pallas_kernels import frozen_tilt as jft
from membrane_solver_tpu_torch.device.state import corner_csr
from membrane_solver_tpu_torch.kernels import _build
from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
from membrane_solver_tpu_torch.kernels import vertex_sum as vs

ENERGY_RTOL = 1e-6
GRAD_RTOL = 5e-6


def _inputs(T=301, seed=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((T, 3, 3)).astype(dtype),
        rng.standard_normal((T, 3, 3)).astype(dtype),
        rng.standard_normal((T, 3, 3)).astype(dtype),
        np.abs(rng.standard_normal((T, 20))).astype(dtype),
        rng.uniform(0.5, 2.0, 6).astype(dtype),
    )


def _vertex_inputs(T=301, seed=7, dtype=np.float32):
    """(t_in, t_out, tri_rows, g, payload, k_vec): vertex tilts and distinct-corner triangles."""
    rng = np.random.default_rng(seed)
    nv = T // 2 + 9
    rows = rng.integers(0, nv, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (nv - 2)) % nv
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (nv - 2)) % nv
    _tin, _tout, g, pay, k = _inputs(T, seed + 1, dtype)
    return (
        rng.standard_normal((nv, 3)).astype(dtype),
        rng.standard_normal((nv, 3)).astype(dtype),
        rows, g, pay, k,
    )


def _torch(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _grad_check(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = float(np.max(np.abs(w)))
        assert float(np.max(np.abs(g - w))) <= GRAD_RTOL * scale


@pytest.mark.parametrize("seed", [7, 13])
def test_twins_match_jax_oracle(seed):
    arrays = _inputs(seed=seed)
    want_e = float(jft.reference_energy(*map(jnp.asarray, arrays)))
    got_e = float(ft.reference_energy(*_torch(arrays)))
    assert got_e == pytest.approx(want_e, rel=ENERGY_RTOL)
    tin, tout, g, pay, k = map(jnp.asarray, arrays)
    want_g = jax.grad(lambda a, b: jft.reference_energy(a, b, g, pay, k), argnums=(0, 1))(tin, tout)
    got_g = ft.reference_grads(*_torch(arrays))
    _grad_check([x.numpy() for x in got_g], want_g)


@pytest.mark.parametrize("seed", [7, 13])
def test_twins_match_jax_pallas_kernel_interpret(monkeypatch, seed):
    """The vertex-level twin against the JAX Pallas kernel in interpret mode on gathered corners."""
    monkeypatch.setenv("MEMBRANE_SOLVER_PALLAS", "1")
    arrays = _vertex_inputs(seed=seed)
    tin, tout, rows, g, pay, k = arrays
    j_rows = jnp.asarray(rows, jnp.int32)
    jg, jpay, jk = map(jnp.asarray, (g, pay, k))

    def jax_energy(a, b):
        return jft.fused_tilt_energy(a[j_rows], b[j_rows], jg, jpay, jk)

    want_e = float(jax_energy(jnp.asarray(tin), jnp.asarray(tout)))
    want_g = jax.grad(jax_energy, argnums=(0, 1))(jnp.asarray(tin), jnp.asarray(tout))
    t_in, t_out, t_rows, tg, tpay, tk = _torch(arrays)
    csr = corner_csr(t_rows, t_in.shape[0])
    e, gin, gout = ft.reference_vertex(t_in, t_out, t_rows, csr, tg, tpay, tk, grad=True)
    assert float(e) == pytest.approx(want_e, rel=ENERGY_RTOL)
    _grad_check([gin.numpy(), gout.numpy()], want_g)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reference_grads_equal_autograd_of_reference_energy(dtype):
    tin, tout, g, pay, k = _torch(_inputs(seed=5, dtype=dtype))
    a, b = tin.clone().requires_grad_(True), tout.clone().requires_grad_(True)
    want = torch.autograd.grad(ft.reference_energy(a, b, g, pay, k), (a, b))
    got = ft.reference_grads(tin, tout, g, pay, k)
    rtol = GRAD_RTOL if dtype == np.float32 else 1e-13
    for x, w in zip(got, want):
        scale = float(torch.max(torch.abs(w)))
        assert float(torch.max(torch.abs(x - w))) <= rtol * scale


def test_vertex_twin_gradient_equals_autograd_through_the_gather_f64():
    """reference_vertex's CSR-summed gradient is autograd of the energy of gathered vertex tilts."""
    t_in, t_out, rows, g, pay, k = _torch(_vertex_inputs(seed=3, dtype=np.float64))
    csr = corner_csr(rows, t_in.shape[0])
    a, b = t_in.clone().requires_grad_(True), t_out.clone().requires_grad_(True)
    want = torch.autograd.grad(ft.reference_energy(a[rows], b[rows], g, pay, k), (a, b))
    _e, gin, gout = ft.reference_vertex(t_in, t_out, rows, csr, g, pay, k, grad=True)
    for x, w in zip((gin, gout), want):
        assert float(torch.max(torch.abs(x - w))) <= 1e-13 * float(torch.max(torch.abs(w)))


def test_cpu_wrapper_runs_twins_and_launches_nothing():
    t_in, t_out, rows, g, pay, k = _torch(_vertex_inputs(seed=9))
    csr = corner_csr(rows, t_in.shape[0])
    before, before_vs = dict(ft.LAUNCHES), dict(vs.LAUNCHES)
    a, b = t_in.clone().requires_grad_(True), t_out.clone().requires_grad_(True)
    e = ft.frozen_tilt_energy(a, b, rows, csr, g, pay, k)
    (3.0 * e).backward()
    want_e, want_in, want_out = ft.reference_vertex(t_in, t_out, rows, csr, g, pay, k, grad=True)
    assert float(e.detach()) == float(want_e)
    assert torch.equal(a.grad, 3.0 * want_in) and torch.equal(b.grad, 3.0 * want_out)
    # without a tilt that requires grad, the energy alone, the same value
    assert float(ft.frozen_tilt_energy(t_in, t_out, rows, csr, g, pay, k)) == float(want_e)
    assert ft.LAUNCHES == before and vs.LAUNCHES == before_vs


def test_launchers_refuse_cpu_tensors():
    """A launch never falls back: a tensor off the card is refused before any build."""
    t_in, t_out, rows, g, pay, k = _torch(_vertex_inputs(T=4))
    csr = corner_csr(rows, t_in.shape[0])
    for grad in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            ft.launch(t_in, t_out, rows, csr, g, pay, k, None, grad=grad)


def test_build_command_targets_hopper_and_is_keyed_by_source():
    flags = " ".join(ft.KERNEL.flags)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    path = ft.KERNEL.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith("frozen_tilt-")
    assert ft.SOURCE.is_file() and ft.SOURCE.suffix == ".cu"
    text = ft.SOURCE.read_text()
    assert 'extern "C" int frozen_tilt_vertex(' in text and '#include "vertex_sum.cuh"' in text
    assert "cp.async.bulk" in text and "kThreads = 128" in text and ft.BLOCK == 128


@pytest.mark.cuda
def test_cuda_kernel_matches_twins():
    """Card only: the CUDA entry point against its twin at T = 301 and 21,504, and its repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    for T, seed in ((301, 7), (21_504, 13)):
        t_in, t_out, rows, g, pay, k = _torch(_vertex_inputs(T=T, seed=seed), device="cuda")
        csr = corner_csr(rows, t_in.shape[0])
        ws = ft.Workspace(T, t_in.device)
        want = ft.reference_vertex(t_in, t_out, rows, csr, g, pay, k, grad=True)
        e_only, _, _ = ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=False)
        got = ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=True)
        again = ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=True)
        for e in (e_only, got[0]):
            assert float(e) == pytest.approx(float(want[0]), rel=ENERGY_RTOL)
        _grad_check([x.cpu().numpy() for x in got[1:]], [x.cpu().numpy() for x in want[1:]])
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        with pytest.raises(TypeError):
            ft.launch(t_in.double(), t_out, rows, csr, g, pay, k, ws, grad=False)
