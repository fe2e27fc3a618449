"""Closed-form symmetric 3x3 eigenvectors and the Kabsch fit.

Counterpart of ``smallest_eigvec_3x3``, ``eigh_3x3`` and ``kabsch`` in
``membrane_solver_tpu/device/linalg.py`` (with ``_eigvals_sym3`` and
``_eigvec_for``): trigonometric Cardano for the eigenvalues and the
largest cross product of two rows of ``A - lam I`` for an eigenvector.  The
ring-plane fits of the rim-source and disk-target energies and the rigid
disk's Kabsch fit use them.  It is kept in the JAX package's closed form rather than
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


def eigh_3x3(A):
    """(eigenvalues ascending (3,), eigenvectors as columns (3, 3)) of a symmetric 3x3.

    The smallest and largest vectors from their own eigenvalues, the middle
    one as their cross product (robust against a near-degenerate pair), or
    from its own eigenvalue where that product vanishes.
    """
    l0, l1, l2 = _eigvals_sym3(A)
    f0 = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    v0 = _eigvec_for(A, l0, f0)
    v2 = _eigvec_for(A, l2, torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype, device=A.device))
    v1 = torch.linalg.cross(v2, v0)
    n1 = torch.linalg.vector_norm(v1)
    v1 = torch.where(n1 > _degen(A.dtype), v1 / torch.clamp(n1, min=_tiny(A.dtype)),
                     _eigvec_for(A, l1, f0))
    return torch.stack([l0, l1, l2]), torch.stack([v0, v1, v2], dim=1)


def rotation_from_cross_covariance(H, eps: float):
    """The proper rotation R that best maps P0 onto Q0, from H = P0^T Q0.

    The right singular vectors V of H come from :func:`eigh_3x3` of H^T H,
    the left ones from H V / sigma; both are re-orthonormalized from their
    two largest columns (the smallest completed by a cross product, so a
    planar set, whose H has rank 2, still gives a basis), and an improper
    result flips V's smallest-singular-value column.  ``eps`` floors the
    singular values and the norms.
    """
    evals, V = eigh_3x3(H.T @ H)  # ascending
    sig = torch.sqrt(torch.clamp(evals, min=eps))
    U = (H @ V) / sig[None, :]
    u2 = U[:, 2] / torch.clamp(torch.linalg.vector_norm(U[:, 2]), min=eps)
    u1 = U[:, 1] - torch.dot(U[:, 1], u2) * u2
    u1 = u1 / torch.clamp(torch.linalg.vector_norm(u1), min=eps)
    u0 = torch.linalg.cross(u1, u2)
    Um = torch.stack([u0, u1, u2], dim=1)
    v2 = V[:, 2]
    v1 = V[:, 1] - torch.dot(V[:, 1], v2) * v2
    v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1), min=eps)
    v0 = torch.linalg.cross(v1, v2)
    Vm = torch.stack([v0, v1, v2], dim=1)
    R = Vm @ Um.T
    Vf = torch.stack([-v0, v1, v2], dim=1)
    det = torch.dot(R[0], torch.linalg.cross(R[1], R[2]))  # +-1 up to round-off
    return torch.where(det < 0.0, Vf @ Um.T, R)


def kabsch(P, Q):
    """Least-squares rigid transform (R, t) mapping the points P (n, 3) onto Q (n, 3)."""
    Pc = torch.mean(P, dim=0)
    Qc = torch.mean(Q, dim=0)
    R = rotation_from_cross_covariance((P - Pc).T @ (Q - Qc), _tiny(P.dtype))
    return R, Qc - R @ Pc
