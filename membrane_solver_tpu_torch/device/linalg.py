"""Closed-form symmetric 3x3 eigenvectors and the Kabsch fit.

Counterpart of ``smallest_eigvec_3x3``, ``eigh_3x3`` and ``kabsch`` in
``membrane_solver_tpu/device/linalg.py`` (with ``_eigvals_sym3`` and
``_eigvec_for``): trigonometric Cardano for the eigenvalues and the
largest cross product of two rows of ``A - lam I`` for an eigenvector.  The
ring-plane fits of the rim-source and disk-target energies and the rigid
disk's Kabsch fit use them.  It is kept in the JAX package's closed form rather than
``torch.linalg.eigh`` so that the fitted normal, and any gradient taken
through it, is the JAX package's, also at the degenerate pair a flat ring
gives (an iterative eigen-solver picks another vector there).  Every sum
and product here adds term by term or in ``device/reduce.tree_sum``'s
fixed order, never through BLAS, so that under ``torch.func.vmap`` (the
parameter sweep) a member's fit is the bits of its own call's.
"""

from __future__ import annotations

import math

import torch

from membrane_solver_tpu_torch.device.reduce import tree_sum


def _tiny(dtype) -> float:
    """Division-guard floor representable in ``dtype``."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def _degen(dtype) -> float:
    """Near-zero threshold for squared magnitudes."""
    return 1e-280 if dtype == torch.float64 else 1e-26


def _axis(k: int, like):
    """The unit vector along axis ``k`` in ``like``'s dtype and device, made on the device.

    A comparison of a device range, not a host tensor or an indexed write:
    either would copy from the host and synchronize.
    """
    return (torch.arange(3, device=like.device) == k).to(like.dtype)


def _eigvals_sym3(A):
    """Eigenvalues of a symmetric 3x3, ascending."""
    q = (A[0, 0] + A[1, 1] + A[2, 2]) / 3.0
    B = A - q * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = tree_sum(B * B) / 6.0
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


def _dot3(a, b):
    """a . b of two 3-vectors, added term by term (a ``torch.dot`` takes BLAS for one call and
    another route under ``torch.func.vmap``, so a member's bits would not be its own call's)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sq3(v):
    """|v|^2 of a 3-vector (:func:`_dot3`)."""
    return _dot3(v, v)


def mm3(A, B):
    """``A @ B`` of (K, 3) rows and a 3x3 as sums of products, term by term: under
    ``torch.func.vmap`` a BLAS product takes its batched form, which adds in another order."""
    return A[:, 0:1] * B[0:1, :] + A[:, 1:2] * B[1:2, :] + A[:, 2:3] * B[2:3, :]


def mv3(A, x):
    """``A @ x`` of a 3x3 and a 3-vector, term by term (see :func:`mm3`)."""
    return A[:, 0] * x[0] + A[:, 1] * x[1] + A[:, 2] * x[2]


def cross_gram_3x3(a, b):
    """``a.T @ b`` of two (K, 3) row sets as a sum of products over the rows, added in
    ``device/reduce.tree_sum``'s fixed order (not a BLAS product, whose batched form under
    ``torch.func.vmap`` adds in another order)."""
    return tree_sum(a[:, :, None] * b[:, None, :], dim=0)


def gram_3x3(rel):
    """``rel.T @ rel`` of (K, 3) rows (:func:`cross_gram_3x3`)."""
    return cross_gram_3x3(rel, rel)


def _eigvec_for(A, lam, fallback):
    """Unit eigenvector of a symmetric 3x3 for eigenvalue ``lam`` (row cross products)."""
    M = A - lam * torch.eye(3, dtype=A.dtype, device=A.device)
    c0 = torch.linalg.cross(M[0], M[1])
    c1 = torch.linalg.cross(M[0], M[2])
    c2 = torch.linalg.cross(M[1], M[2])
    n0, n1, n2 = _sq3(c0), _sq3(c1), _sq3(c2)
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
        fallback = _axis(2, A)
    lam_min, _, _ = _eigvals_sym3(A)
    return _eigvec_for(A, lam_min, fallback)


def eigh_3x3(A):
    """(eigenvalues ascending (3,), eigenvectors as columns (3, 3)) of a symmetric 3x3.

    The smallest and largest vectors from their own eigenvalues, the middle
    one as their cross product (robust against a near-degenerate pair), or
    from its own eigenvalue where that product vanishes.
    """
    l0, l1, l2 = _eigvals_sym3(A)
    f0 = _axis(2, A)
    v0 = _eigvec_for(A, l0, f0)
    v2 = _eigvec_for(A, l2, _axis(0, A))
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
    evals, V = eigh_3x3(mm3(H.T, H))  # ascending
    sig = torch.sqrt(torch.clamp(evals, min=eps))
    U = mm3(H, V) / sig[None, :]
    u2 = U[:, 2] / torch.clamp(torch.linalg.vector_norm(U[:, 2]), min=eps)
    u1 = U[:, 1] - _dot3(U[:, 1], u2) * u2
    u1 = u1 / torch.clamp(torch.linalg.vector_norm(u1), min=eps)
    u0 = torch.linalg.cross(u1, u2)
    Um = torch.stack([u0, u1, u2], dim=1)
    v2 = V[:, 2]
    v1 = V[:, 1] - _dot3(V[:, 1], v2) * v2
    v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1), min=eps)
    v0 = torch.linalg.cross(v1, v2)
    Vm = torch.stack([v0, v1, v2], dim=1)
    R = mm3(Vm, Um.T)
    Vf = torch.stack([-v0, v1, v2], dim=1)
    det = _dot3(R[0], torch.linalg.cross(R[1], R[2]))  # +-1 up to round-off
    return torch.where(det < 0.0, mm3(Vf, Um.T), R)


def kabsch(P, Q):
    """Least-squares rigid transform (R, t) mapping the points P (n, 3) onto Q (n, 3)."""
    Pc = tree_sum(P, dim=0) / P.shape[0]
    Qc = tree_sum(Q, dim=0) / Q.shape[0]
    R = rotation_from_cross_covariance(cross_gram_3x3(P - Pc, Q - Qc), _tiny(P.dtype))
    return R, Qc - mv3(R, Pc)
