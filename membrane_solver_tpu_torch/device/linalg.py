"""Closed-form symmetric 3x3 eigenvectors.

Counterpart of ``smallest_eigvec_3x3`` in ``membrane_solver_tpu/device/linalg.py``
(with ``_eigvals_sym3`` and ``_eigvec_for``): trigonometric Cardano for the
eigenvalues and the largest cross product of two rows of ``A - lam I`` for
the eigenvector.  The ring-plane fits of the rim-source and disk-target
energies use it.  It is kept in the JAX package's closed form rather than
``torch.linalg.eigh`` so that the fitted normal, and any gradient taken
through it, is the JAX package's, also at the degenerate pair a flat ring
gives (an iterative eigen-solver picks another vector there).
"""

from __future__ import annotations

import math

import torch


def _tiny(dtype) -> float:
    """Division-guard floor representable in ``dtype``."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def _degen(dtype) -> float:
    """Near-zero threshold for squared magnitudes."""
    return 1e-280 if dtype == torch.float64 else 1e-26


def _eigvals_sym3(A):
    """Eigenvalues of a symmetric 3x3, ascending."""
    q = torch.trace(A) / 3.0
    B = A - q * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_tiny(A.dtype)))
    detB = (
        B[0, 0] * (B[1, 1] * B[2, 2] - B[1, 2] * B[2, 1])
        - B[0, 1] * (B[1, 0] * B[2, 2] - B[1, 2] * B[2, 0])
        + B[0, 2] * (B[1, 0] * B[2, 1] - B[1, 1] * B[2, 0])
    )
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    degenerate = p2 < _degen(A.dtype)  # all three equal q
    return (
        torch.where(degenerate, q, e3),
        torch.where(degenerate, q, e2),
        torch.where(degenerate, q, e1),
    )


def _eigvec_for(A, lam, fallback):
    """Unit eigenvector of a symmetric 3x3 for eigenvalue ``lam`` (row cross products)."""
    M = A - lam * torch.eye(3, dtype=A.dtype, device=A.device)
    c0 = torch.linalg.cross(M[0], M[1])
    c1 = torch.linalg.cross(M[0], M[2])
    c2 = torch.linalg.cross(M[1], M[2])
    n0, n1, n2 = torch.dot(c0, c0), torch.dot(c1, c1), torch.dot(c2, c2)
    best = torch.where((n0 >= n1) & (n0 >= n2), c0, torch.where(n1 >= n2, c1, c2))
    nbest = torch.maximum(n0, torch.maximum(n1, n2))
    return torch.where(
        nbest > _degen(A.dtype),
        best / torch.sqrt(torch.clamp(nbest, min=_tiny(A.dtype))),
        fallback,
    )


def smallest_eigvec_3x3(A, fallback=None):
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3."""
    if fallback is None:
        fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    lam_min, _, _ = _eigvals_sym3(A)
    return _eigvec_for(A, lam_min, fallback)
