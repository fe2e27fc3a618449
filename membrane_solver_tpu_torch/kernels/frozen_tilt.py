"""Fused frozen-tilt energy: CUDA kernel wrapper and its plain-torch twins.

Counterpart of ``membrane_solver_tpu/pallas_kernels/frozen_tilt.py``.  One
pass per triangle evaluates the four triangle-supported frozen tilt
energies of the caveolin/Kozlov lanes (lumped tilt mass of both leaflets,
the two bending-tilt corner forms, and the tilt-smoothness Dirichlet terms
when active); the backward pass is analytic.  The kernels live in
``csrc/frozen_tilt.cu``, are compiled with ``nvcc`` for ``sm_90a`` at first
use into ``_build/`` (keyed by a hash of the source), and are bound with
``ctypes``.

Dispatch: a CUDA float32 tensor launches the kernel (after shape,
contiguity and dtype checks); any other CUDA tensor raises.  A CPU tensor
runs the twins, :func:`reference_energy` and :func:`reference_grads`,
which have the same arithmetic.  ``LAUNCHES`` counts kernel launches.

Inputs: tin_c, tout_c (T, 3, 3) gathered corner tilts; g (T, 3, 3) P1 shape
gradients; payload (T, 20) = [A_in, A_out, base_in(3), va_in(3),
base_out(3), va_out(3), w_in(3), w_out(3)]; k_vec (6,) = [k_in, k_out,
kappa_in, kappa_out, ks_in, ks_out].
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

LAUNCHES = {"fwd": 0, "bwd": 0}

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "frozen_tilt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib = None


# ----------------------------------------------------------------------
# plain-torch twins
# ----------------------------------------------------------------------
def _split(payload, k_vec):
    return (
        payload[:, 0], payload[:, 1], payload[:, 2:5], payload[:, 5:8],
        payload[:, 8:11], payload[:, 11:14], payload[:, 14:17], payload[:, 17:20],
        *k_vec.unbind(),
    )


def reference_energy(tin_c, tout_c, g, payload, k_vec):
    """Plain twin of the forward kernel: the scalar frozen-tilt energy."""
    (A_in, A_out, base_in, va_in, base_out, va_out, w_in, w_out,
     k_in, k_out, kap_in, kap_out, ks_in, ks_out) = _split(payload, k_vec)
    sq_in = torch.sum(tin_c * tin_c, dim=(1, 2))
    sq_out = torch.sum(tout_c * tout_c, dim=(1, 2))
    e = 0.5 * k_in * (sq_in / 3.0) * A_in + 0.5 * k_out * (sq_out / 3.0) * A_out
    div_in = torch.sum(tin_c * g, dim=(1, 2))
    div_out = torch.sum(tout_c * g, dim=(1, 2))
    term_in = base_in - div_in[:, None]
    term_out = base_out + div_out[:, None]
    e = e + 0.5 * kap_in * torch.sum(term_in**2 * va_in, dim=1)
    e = e + 0.5 * kap_out * torch.sum(term_out**2 * va_out, dim=1)

    def dir_sq(t):
        d12 = t[:, 1] - t[:, 2]
        d20 = t[:, 2] - t[:, 0]
        d01 = t[:, 0] - t[:, 1]
        return torch.stack(
            [torch.sum(d12 * d12, dim=1), torch.sum(d20 * d20, dim=1),
             torch.sum(d01 * d01, dim=1)],
            dim=1,
        )

    e = e + 0.25 * ks_in * torch.sum(w_in * dir_sq(tin_c), dim=1)
    e = e + 0.25 * ks_out * torch.sum(w_out * dir_sq(tout_c), dim=1)
    return torch.sum(e)


def _dirichlet_grad(t, w, half_k):
    d12 = t[:, 1] - t[:, 2]
    d20 = t[:, 2] - t[:, 0]
    d01 = t[:, 0] - t[:, 1]
    w0, w1, w2 = w[:, 0:1], w[:, 1:2], w[:, 2:3]
    return half_k * torch.stack(
        [w2 * d01 - w1 * d20, w0 * d12 - w2 * d01, w1 * d20 - w0 * d12], dim=1
    )


def reference_grads(tin_c, tout_c, g, payload, k_vec):
    """Plain twin of the gradient kernel: (dE/dtin_c, dE/dtout_c), each (T, 3, 3)."""
    (A_in, A_out, base_in, va_in, base_out, va_out, w_in, w_out,
     k_in, k_out, kap_in, kap_out, ks_in, ks_out) = _split(payload, k_vec)
    div_in = torch.sum(tin_c * g, dim=(1, 2))
    div_out = torch.sum(tout_c * g, dim=(1, 2))
    s_in = torch.sum((base_in - div_in[:, None]) * va_in, dim=1)
    s_out = torch.sum((base_out + div_out[:, None]) * va_out, dim=1)
    m_in = (k_in * A_in / 3.0)[:, None, None]
    m_out = (k_out * A_out / 3.0)[:, None, None]
    din = m_in * tin_c - (kap_in * s_in)[:, None, None] * g
    dout = m_out * tout_c + (kap_out * s_out)[:, None, None] * g
    return (
        din + _dirichlet_grad(tin_c, w_in, 0.5 * ks_in),
        dout + _dirichlet_grad(tout_c, w_out, 0.5 * ks_out),
    )


# ----------------------------------------------------------------------
# build and launch
# ----------------------------------------------------------------------
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"frozen_tilt-{digest[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile the kernels (once per source hash) and load them."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.frozen_tilt_energy.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr]
    lib.frozen_tilt_energy.restype = i32
    lib.frozen_tilt_grad.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr]
    lib.frozen_tilt_grad.restype = i32
    _lib = lib
    return lib


def build_log() -> str:
    """The compiler's output (ptxas register and spill report) of the build."""
    return library_path().with_suffix(".log").read_text()


def _check_inputs(tin_c, tout_c, g, payload, k_vec) -> int:
    T = tin_c.shape[0]
    expected = {
        "tin_c": (tin_c, (T, 3, 3)),
        "tout_c": (tout_c, (T, 3, 3)),
        "g": (g, (T, 3, 3)),
        "payload": (payload, (T, 20)),
        "k_vec": (k_vec, (6,)),
    }
    for name, (x, shape) in expected.items():
        if not x.is_cuda or x.device != tin_c.device:
            raise ValueError(f"{name} must lie on {tin_c.device}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"the frozen_tilt kernel takes float32; {name} is {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if T >= 2**31:
        raise ValueError(f"{T} triangles exceed the kernel's int index")
    return T


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {code}")


def launch_energy(tin_c, tout_c, g, payload, k_vec) -> torch.Tensor:
    """Per-triangle energies (T,) from the forward kernel."""
    T = _check_inputs(tin_c, tout_c, g, payload, k_vec)
    lib = build()
    energy = torch.empty(T, dtype=torch.float32, device=tin_c.device)
    stream = torch.cuda.current_stream(tin_c.device).cuda_stream
    code = lib.frozen_tilt_energy(
        tin_c.data_ptr(), tout_c.data_ptr(), g.data_ptr(), payload.data_ptr(),
        k_vec.data_ptr(), energy.data_ptr(), T, stream,
    )
    _raise_on(code, "frozen_tilt_energy")
    LAUNCHES["fwd"] += 1
    return energy


def launch_grads(tin_c, tout_c, g, payload, k_vec, ct):
    """(dE/dtin_c, dE/dtout_c) scaled by the 1-element device tensor ``ct``."""
    T = _check_inputs(tin_c, tout_c, g, payload, k_vec)
    ct = ct.reshape(1)
    if not ct.is_cuda or ct.dtype != torch.float32:
        raise TypeError(f"the incoming gradient must be a CUDA float32 scalar, got {ct}")
    lib = build()
    din = torch.empty_like(tin_c)
    dout = torch.empty_like(tout_c)
    stream = torch.cuda.current_stream(tin_c.device).cuda_stream
    code = lib.frozen_tilt_grad(
        tin_c.data_ptr(), tout_c.data_ptr(), g.data_ptr(), payload.data_ptr(),
        k_vec.data_ptr(), ct.data_ptr(), din.data_ptr(), dout.data_ptr(), T, stream,
    )
    _raise_on(code, "frozen_tilt_grad")
    LAUNCHES["bwd"] += 1
    return din, dout


class _FusedTiltEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tin_c, tout_c, g, payload, k_vec):
        ctx.save_for_backward(tin_c, tout_c, g, payload, k_vec)
        if tin_c.is_cuda:
            return torch.sum(launch_energy(tin_c, tout_c, g, payload, k_vec))
        return reference_energy(tin_c, tout_c, g, payload, k_vec)

    @staticmethod
    def backward(ctx, ct):
        tin_c, tout_c, g, payload, k_vec = ctx.saved_tensors
        if tin_c.is_cuda:
            din, dout = launch_grads(tin_c, tout_c, g, payload, k_vec, ct.contiguous())
        else:
            din, dout = reference_grads(tin_c, tout_c, g, payload, k_vec)
            din, dout = ct * din, ct * dout
        return din, dout, None, None, None


def fused_tilt_energy(tin_c, tout_c, g, payload, k_vec):
    """Scalar frozen-tilt energy of the four triangle modules (autograd-aware)."""
    return _FusedTiltEnergy.apply(tin_c, tout_c, g, payload, k_vec)
