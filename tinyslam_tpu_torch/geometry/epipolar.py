"""Two-view triangulation (mirrors ``triangulate`` and ``depths`` of
``tinyslam_tpu/geometry/epipolar.py``; the essential-matrix solvers belong
to the bootstrap and are not ported yet).

Cameras map world -> camera: Xc = R X + t.
"""

from __future__ import annotations

import torch


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
