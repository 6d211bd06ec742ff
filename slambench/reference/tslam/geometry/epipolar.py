"""Two-view epipolar geometry: the essential matrix, its 8-point estimate,
Sampson error and decomposition, and triangulation (mirrors
``tinyslam_tpu/geometry/epipolar.py``).

Correspondences are in normalized image coordinates.  Cameras map world ->
camera: Xc = R X + t; for P1 = [I|0] and P2 = [R|t], x2^T E x1 = 0 with
E = [t]_x R.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference.tslam.geometry.linalg import det3, null_vector, svd3
from slambench.reference.tslam.geometry.se3 import so3_hat


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def essential_from_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R (up to scale)."""
    return so3_hat(t) @ R


def hartley_normalize(x: torch.Tensor, w: torch.Tensor):
    """Weighted centring and scaling to mean distance sqrt(2): returns
    (normalized x (..., N, 2), centroid (..., 2), scale (...,))."""
    wsum = torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    mean = (x * w[..., None]).sum(-2, keepdim=True) / wsum[..., None]
    d = torch.linalg.norm(x - mean, dim=-1)
    mean_d = (d * w).sum(-1, keepdim=True) / wsum
    s = np.sqrt(2.0) / torch.clamp_min(mean_d, 1e-9)
    return (x - mean) * s[..., None], mean[..., 0, :], s[..., 0]


def similarity3(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The 3x3 matrix of x -> s (x - c) on homogeneous points."""
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, z, -s * c[..., 0]], dim=-1),
        torch.stack([z, s, -s * c[..., 1]], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def eight_point_essential(x1: torch.Tensor, x2: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted 8-point essential estimate.

    x1, x2 (..., N, 2) normalized correspondences (N >= 8); weights (..., N)
    nonnegative (0 disables a row).  Points are Hartley-normalized first;
    the result is projected onto the essential manifold (singular values
    (1, 1, 0)).  Returns (..., 3, 3).
    """
    w = torch.ones_like(x1[..., 0]) if weights is None else weights
    x1n, c1, s1 = hartley_normalize(x1, w)
    x2n, c2, s2 = hartley_normalize(x2, w)
    h1, h2 = _homog(x1n), _homog(x2n)
    # Row for pair i: kron(h2_i, h1_i) . vec(E) = 0 with vec row-major.
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*h1.shape[:-1], 9)
    if weights is not None:
        A = A * weights[..., None]
    e = null_vector(A)
    En = e.reshape(*e.shape[:-1], 3, 3)
    E = similarity3(c2, s2).transpose(-1, -2) @ En @ similarity3(c1, s1)
    u, s, vt = svd3(E)
    sig = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (u * sig) @ vt


def sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared first-order geometric (Sampson) error of x2^T E x1 = 0.
    E (..., 3, 3); x1, x2 (..., N, 2).  Returns (..., N)."""
    h1, h2 = _homog(x1), _homog(x2)
    Ex1 = torch.einsum("...ij,...nj->...ni", E, h1)
    Etx2 = torch.einsum("...ji,...nj->...ni", E, h2)
    num = (h2 * Ex1).sum(-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return (num * num) / torch.clamp_min(den, 1e-12)


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t): the four candidate poses are (R1, +-t), (R2, +-t)."""
    u, _, vt = svd3(E)
    du = det3(u)[..., None, None]
    dv = det3(vt)[..., None, None]
    one = torch.ones_like(du)
    u = u * torch.cat([one, one, du], dim=-1)
    vt = vt * torch.cat([one, one, dv], dim=-2)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return u @ W @ vt, u @ W.T @ vt, u[..., :, 2]


def triangulate(R1: torch.Tensor, t1: torch.Tensor, x1: torch.Tensor,
                R2: torch.Tensor, t2: torch.Tensor, x2: torch.Tensor,
                eps: float = 1e-9) -> torch.Tensor:
    """Linear triangulation of N correspondences.

    x1, x2: (..., N, 2) normalized observations.  Returns world points
    (..., N, 3).  Each point solves the 3x3 normal equations of its four
    linear constraints (u * row3 - row1) . X = t[0] - u * t[2] (and the
    same for v) with ``torch.linalg.solve_ex``, which reads no error flag
    back to the host; a singular system gives non-finite X, which callers
    gate.
    """
    def rows(R, t, x):
        u = x[..., 0:1]
        v = x[..., 1:2]
        r0 = u * R[..., None, 2, :] - R[..., None, 0, :]   # (..., N, 3)
        r1 = v * R[..., None, 2, :] - R[..., None, 1, :]
        b0 = t[..., None, 0] - x[..., 0] * t[..., None, 2]  # (..., N)
        b1 = t[..., None, 1] - x[..., 1] * t[..., None, 2]
        return torch.stack([r0, r1], dim=-2), torch.stack([b0, b1], dim=-1)

    A1, b1 = rows(R1, t1, x1)
    A2, b2 = rows(R2, t2, x2)
    A = torch.cat([A1, A2], dim=-2)                    # (..., N, 4, 3)
    b = torch.cat([b1, b2], dim=-1)                    # (..., N, 4)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    Atb = torch.einsum("...ki,...k->...i", A, b)
    AtA = AtA + eps * torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(AtA, Atb[..., None])[0][..., 0]


def depths(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """z-coordinate of world points X (..., N, 3) in camera (R, t)."""
    return torch.einsum("...j,...nj->...n", R[..., 2, :], X) + t[..., None, 2]
