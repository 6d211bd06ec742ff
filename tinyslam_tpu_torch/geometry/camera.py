"""Pinhole camera model (mirrors ``tinyslam_tpu/geometry/camera.py``).

Convention: world points X_w; camera pose (R, t) maps world -> camera:
X_c = R X_w + t.  Pixels u = K pi(X_c) with pi the perspective division.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class PinholeCamera:
    """Intrinsics as Python floats holding float32 values, so that tensor
    arithmetic with them rounds as the JAX package's float32 arrays do."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def create(fx, fy, cx, cy) -> "PinholeCamera":
        f = lambda v: float(np.float32(v))
        return PinholeCamera(f(fx), f(fy), f(cx), f(cy))

    def project(self, xc: torch.Tensor, eps: float = 1e-6):
        """Camera-frame points (..., 3) -> pixels (..., 2), plus a validity
        mask (point in front of the camera)."""
        z = xc[..., 2]
        valid = z > eps
        zs = torch.where(valid, z, torch.ones_like(z))
        u = self.fx * xc[..., 0] / zs + self.cx
        v = self.fy * xc[..., 1] / zs + self.cy
        return torch.stack([u, v], dim=-1), valid

    def backproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> unit-depth camera rays (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def normalize(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels -> normalized image coordinates (x/z, y/z)."""
        return self.backproject(uv)[..., :2]
