"""membrane_solver_tpu_torch: the membrane solver on PyTorch and CUDA.

A port of ``membrane_solver_tpu`` (the JAX package, kept as the reference)
to PyTorch, with the Pallas kernels of its main path rewritten as CUDA
kernels for Hopper (``csrc/``, bound in ``kernels/``).  The host layer
(mesh entities, readers and writers, mesh generators, refinement) is a copy
of the JAX package's NumPy code; the device layer runs eagerly on tensors.

Device and dtype are explicit: ``Minimizer(mesh, device="cuda",
dtype=torch.float64)``.  float64 is the parity mode, float32 the
throughput mode.  float32 matrix products and convolutions run in full
float32 (no TF32), as the JAX package pins ``highest`` matmul precision.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from membrane_solver_tpu_torch.geometry.io_readers import load_data, parse_geometry  # noqa: E402
from membrane_solver_tpu_torch.geometry.io_writers import save_geometry  # noqa: E402
from membrane_solver_tpu_torch.geometry.mesh import Mesh  # noqa: E402
from membrane_solver_tpu_torch.runtime.minimizer import Minimizer  # noqa: E402

__all__ = ["Minimizer", "Mesh", "load_data", "parse_geometry", "save_geometry"]
