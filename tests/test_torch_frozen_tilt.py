"""The frozen-tilt kernel's plain twins and wrapper against the JAX package.

On the CPU the wrapper runs the twins (``reference_energy``,
``reference_grads``); they must match the JAX package's oracle and its
Pallas kernel in interpret mode at float32, T = 301: energy to rel 1e-6,
gradient to 5e-6 * max|g| (the JAX kernel tests' bounds).  The CUDA
kernel itself is checked against the twins by ``chip_smoke.py`` on the
card, and by the CUDA-only test here where CUDA and JAX are both present.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from membrane_solver_tpu.pallas_kernels import frozen_tilt as jft
from membrane_solver_tpu_torch.kernels import _build
from membrane_solver_tpu_torch.kernels import frozen_tilt as ft

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
    """The JAX Pallas kernel in interpret mode (the JAX tests' CPU route)."""
    monkeypatch.setenv("MEMBRANE_SOLVER_PALLAS", "1")
    arrays = _inputs(seed=seed)
    tin, tout, g, pay, k = map(jnp.asarray, arrays)
    want_e = float(jft.fused_tilt_energy(tin, tout, g, pay, k))
    want_g = jax.grad(lambda a, b: jft.fused_tilt_energy(a, b, g, pay, k), argnums=(0, 1))(tin, tout)
    assert float(ft.reference_energy(*_torch(arrays))) == pytest.approx(want_e, rel=ENERGY_RTOL)
    _grad_check([x.numpy() for x in ft.reference_grads(*_torch(arrays))], want_g)


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


def test_cpu_wrapper_runs_twins_and_launches_nothing():
    arrays = _torch(_inputs(seed=9))
    before = dict(ft.LAUNCHES)
    tin, tout, g, pay, k = arrays
    a, b = tin.clone().requires_grad_(True), tout.clone().requires_grad_(True)
    e = ft.fused_tilt_energy(a, b, g, pay, k)
    (3.0 * e).backward()
    assert float(e.detach()) == float(ft.reference_energy(tin, tout, g, pay, k))
    want = ft.reference_grads(tin, tout, g, pay, k)
    assert torch.equal(a.grad, 3.0 * want[0]) and torch.equal(b.grad, 3.0 * want[1])
    assert ft.LAUNCHES == before


def test_launchers_refuse_cpu_tensors():
    """A launch never falls back: a tensor off the card is refused before any build."""
    arrays = _torch(_inputs(T=4))
    with pytest.raises(ValueError, match="must lie on"):
        ft.launch_energy(*arrays)
    with pytest.raises(ValueError, match="must lie on"):
        ft.launch_grads(*arrays, torch.ones(()))


def test_build_command_targets_hopper_and_is_keyed_by_source():
    flags = " ".join(ft.KERNEL.flags)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    path = ft.KERNEL.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith("frozen_tilt-")
    assert ft.SOURCE.is_file() and ft.SOURCE.suffix == ".cu"


def test_cuda_kernel_matches_twins():
    """Card only: the CUDA kernels against the twins at T = 301 and 21,504."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    for T, seed in ((301, 7), (21_504, 13)):
        tin, tout, g, pay, k = _torch(_inputs(T=T, seed=seed), device="cuda")
        e_k = float(ft.fused_tilt_energy(tin, tout, g, pay, k))
        e_t = float(ft.reference_energy(tin, tout, g, pay, k))
        assert e_k == pytest.approx(e_t, rel=ENERGY_RTOL)
        ones = torch.ones((), dtype=torch.float32, device="cuda")
        got = ft.launch_grads(tin, tout, g, pay, k, ones)
        want = ft.reference_grads(tin, tout, g, pay, k)
        _grad_check([x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want])
        with pytest.raises(TypeError):
            ft.launch_energy(tin.double(), tout, g, pay, k)
