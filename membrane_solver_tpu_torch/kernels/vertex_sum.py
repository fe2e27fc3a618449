"""Deterministic corner-to-vertex sums: CUDA kernel wrapper and its plain twin.

Per-triangle kernels produce one row per triangle corner; the energy needs
them per vertex.  The vertex-sum kernel (``csrc/vertex_sum.cuh``, one
thread per vertex) adds each vertex's corner rows in the order of the
topology's :class:`~membrane_solver_tpu_torch.device.state.CornerCSR`, so
the sums are the same bits on every run, where ``index_add`` on the card
adds with float atomics in a changing order.  The frozen-tilt, surface,
curvature and divergence entry points launch it inside their own calls
(the divergence's tilt backward in its weighted form), and their CPU
paths take :func:`reference`, which adds in the same order; :func:`launch` runs it
alone (``csrc/vertex_sum.cu``) on CUDA tensors, after device, dtype, shape
and contiguity checks that raise on anything else.
``LAUNCHES["vertex_sum"]`` counts every launch of the kernel, from this
module's wrapper and from the entry points that launch it.
"""

from __future__ import annotations

import ctypes

import torch

from membrane_solver_tpu_torch.device.state import CornerCSR
from membrane_solver_tpu_torch.kernels import _build

LAUNCHES = {"vertex_sum": 0}

KERNEL = _build.Source("vertex_sum")
SOURCE = KERNEL.path
HEADER = SOURCE.with_suffix(".cuh")

_lib = None


def reference(corner_values: torch.Tensor, csr: CornerCSR, weight=None) -> torch.Tensor:
    """Plain twin: (T, 3, *w) corner rows summed into (N, *w) vertex rows in CSR order.

    Round k adds every vertex's k-th corner (zero past its last), so each
    vertex row is ``((0 + c_0) + c_1) + ...`` in slot order, as the kernel
    adds; ``x + 0`` is exact, so the padding changes no bit.  With ``weight``
    (T,), each corner row is first multiplied by its triangle's weight, as
    the weighted kernel does (``launch_weighted`` in ``csrc/vertex_sum.cuh``).
    """
    T = corner_values.shape[0]
    width = corner_values.shape[2:]
    flat = corner_values.reshape(3 * T, -1)
    starts = csr.offsets[:-1].long()
    degree = csr.offsets[1:].long() - starts
    slots = csr.slots.long()
    out = flat.new_zeros((csr.n_rows, flat.shape[1]))
    for k in range(csr.max_degree):
        live = degree > k
        slot = slots[torch.where(live, starts + k, 0)]
        rows = flat[slot]
        if weight is not None:
            rows = weight[slot // 3][:, None] * rows
        out = out + torch.where(live[:, None], rows, 0.0)
    return out.reshape((csr.n_rows,) + tuple(width))


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    (lib,) = _build.build(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vertex_sum_rows.argtypes = [i32, i32, ptr, ptr, ptr, ptr, i32, ptr]
    lib.vertex_sum_rows.restype = i32
    _lib = lib
    return lib


def check_csr(csr: CornerCSR, like: torch.Tensor, n_triangles: int) -> None:
    """The CSR on ``like``'s device, int32, contiguous, with 3 * ``n_triangles`` slots."""
    for name, x, shape in (("offsets", csr.offsets, (csr.n_rows + 1,)),
                           ("slots", csr.slots, (3 * n_triangles,))):
        if x.device != like.device:
            raise ValueError(f"csr.{name} must lie on {like.device}, got {x.device}")
        if x.dtype != torch.int32 or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"csr.{name} must be contiguous int32 of shape {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")


def launch(corner_values: torch.Tensor, csr: CornerCSR) -> torch.Tensor:
    """(N, *w) vertex rows from the kernel; ``corner_values`` (T, 3) or (T, 3, 3), on the card."""
    if not corner_values.is_cuda:
        raise ValueError(f"the vertex_sum launch takes CUDA tensors, got {corner_values.device}")
    if corner_values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vertex_sum takes float32 or float64, got {corner_values.dtype}")
    if corner_values.dim() not in (2, 3) or corner_values.shape[1] != 3 or (
            corner_values.dim() == 3 and corner_values.shape[2] != 3):
        raise ValueError(f"corner values must be (T, 3) or (T, 3, 3), got "
                         f"{tuple(corner_values.shape)}")
    if not corner_values.is_contiguous():
        raise ValueError("corner values must be contiguous")
    check_csr(csr, corner_values, corner_values.shape[0])
    width = 3 if corner_values.dim() == 3 else 1
    lib = build()
    out = corner_values.new_empty((csr.n_rows,) + tuple(corner_values.shape[2:]))
    code = lib.vertex_sum_rows(
        int(corner_values.dtype == torch.float64), width, csr.offsets.data_ptr(),
        csr.slots.data_ptr(), corner_values.data_ptr(), out.data_ptr(), csr.n_rows,
        torch.cuda.current_stream(corner_values.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"vertex_sum_rows launch failed: cudaError {code}")
    LAUNCHES["vertex_sum"] += 1
    return out
