"""Small-matrix factorizations of the two-view and PnP solvers (mirrors
``null_vector``, ``exact_null_space``, ``polar_rotation3`` and ``svd3`` of
``tinyslam_tpu/geometry/linalg.py``).

Everything is batched over leading dimensions.  ``torch.linalg.eigh``
reads an error flag back to the host on the card, so ``null_vector`` and
``svd3``, which keep the reference's ``eigh``, synchronize once a call
there; only the bootstrap runs them.  The relocalization path reads
nothing back: its DLT uses ``minimal_null_vector`` (inverse iteration from
a fixed start, ``torch.linalg.solve_ex``), ``polar_rotation3`` is a Newton
iteration with a closed-form 3x3 inverse.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _refine(Mr: torch.Tensor, v: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` rounds of inverse iteration v <- Mr^-1 v, normalized with
    the sign of a one-column Householder QR (the first component is not
    positive), as the reference's ``refine_null_space`` for k = 1."""
    for _ in range(iters):
        v = torch.linalg.solve_ex(Mr, v[..., None])[0][..., 0]
        v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-30)
        v = v * torch.where(v[..., :1] >= 0, -1.0, 1.0)
    return v


def eigh_vectors(M: torch.Tensor) -> torch.Tensor:
    """Eigenvectors (ascending eigenvalues) of symmetric M (..., n, n).
    ``torch.linalg.eigh`` raises on a non-finite matrix where
    ``jnp.linalg.eigh`` returns NaN (a degenerate RANSAC refit produces
    such matrices); here such a matrix gets NaN eigenvectors, as there."""
    bad = ~torch.isfinite(M).all(-1).all(-1)[..., None, None]
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    V = torch.linalg.eigh(torch.where(bad, eye, M)).eigenvectors
    return torch.where(bad, torch.full_like(V, float("nan")), V)


def _normal_matrix(A: torch.Tensor, eps_scale: float):
    M = torch.einsum("...ki,...kj->...ij", A, A)
    n = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return M, M + (eps_scale / n) * tr * torch.eye(n, dtype=M.dtype, device=M.device)


def null_vector(A: torch.Tensor) -> torch.Tensor:
    """Least-squares null vector of A (..., m, n): the smallest eigenvector
    of A^T A (``eigh``), polished by two rounds of inverse iteration
    against A^T A + 1e-8 tr / n I.  Returns (..., n), first component not
    positive.  One sync on the card (``eigh``'s error check)."""
    M, Mr = _normal_matrix(A, 1e-8)
    return _refine(Mr, eigh_vectors(M)[..., 0], 2)


@functools.lru_cache(maxsize=8)
def _start_on(n: int, device: torch.device) -> torch.Tensor:
    """A fixed start vector with no structure (one orthogonal to the null
    vector, such as all ones against a skew-symmetric essential matrix,
    would never converge), uploaded to ``device`` once: a copy from host
    memory on every call would synchronize the host with the device."""
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)


def minimal_null_vector(A: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """``null_vector`` of a minimal system, whose null space has dimension
    one, without ``eigh``: inverse iteration from a fixed start.  There the
    shift 1e-8 tr / n lies some 1e4-1e5 below the second eigenvalue, so
    each round gains that factor and ``iters`` = 4 reaches float32; it does
    not converge on an overdetermined system whose two smallest eigenvalues
    are close.  Reads nothing back on the card."""
    M, Mr = _normal_matrix(A, 1e-8)
    start = _start_on(M.shape[-1], M.device).to(M.dtype)
    return _refine(Mr, start.expand(*M.shape[:-1]), iters)


def exact_null_space(A: torch.Tensor, k: int) -> torch.Tensor:
    """Null-space basis (..., n, k) of a minimal system A (..., n - k, n):
    the last k columns of the complete QR of A^T (Householder, the LAPACK
    convention, so the basis is the reference's)."""
    q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    return q[..., -k:]


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) 3x3 inverse, the determinant floored at 1e-30."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    det = torch.where(det.abs() > 1e-30, det, torch.full_like(det, 1e-30))
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by the rule of Sarrus (no LU)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def polar_rotation3(M: torch.Tensor, iters: int = 9) -> torch.Tensor:
    """Orthogonal polar factor of M (..., 3, 3) by the Newton iteration
    X <- (X + X^-T) / 2 after Frobenius scaling; det(result) = sign(det M).
    A singular M gives a non-finite factor, which loses the RANSAC vote."""
    nrm = torch.sqrt((M * M).sum((-2, -1), keepdim=True))
    X = M / torch.clamp_min(nrm, 1e-30) * np.sqrt(3.0)
    for _ in range(iters):
        X = 0.5 * (X + _inv3(X).transpose(-1, -2))
    return X


def svd3(M: torch.Tensor):
    """SVD of M (..., 3, 3) assembled from eigh(M^T M): returns (u, s, vt)
    with s descending and M = u diag(s) vt.  Singular values are |M v_i|;
    where the third is below 1e-4 of the first, u's third column is the
    cross product of the first two.  Each column of V is signed so that
    its largest entry is positive, so that the card and the CPU agree."""
    MtM = torch.einsum("...ki,...kj->...ij", M, M)
    V = eigh_vectors(MtM).flip(-1)                       # descending columns
    big = V.abs().argmax(-2, keepdim=True)
    V = V * torch.where(V.gather(-2, big) < 0, -1.0, 1.0)
    MV = M @ V
    s = torch.linalg.norm(MV, dim=-2)
    U = MV / torch.clamp_min(s, 1e-30)[..., None, :]
    u2_cross = torch.cross(U[..., :, 0], U[..., :, 1], dim=-1)
    tiny = (s[..., 2] < 1e-4 * torch.clamp_min(s[..., 0], 1e-30))[..., None]
    u2 = torch.where(tiny, u2_cross, U[..., :, 2])
    U = torch.cat([U[..., :, :2], u2[..., :, None]], dim=-1)
    return U, s, V.transpose(-1, -2)
