"""Reprojection residuals and analytic Jacobians for bundle adjustment
(mirrors ``tinyslam_tpu/backend/residuals.py:reprojection_residuals``).

Dense over the (landmark, keyframe) grid with a visibility mask: invisible
observations carry zero weight instead of being absent, so no shape
depends on the data.  The JAX package also keeps a landmarks-last copy
(``reprojection_residuals_ll``) only to put L on the TPU's 128-wide lanes;
this port has the one (L, K, ...) layout.
"""

from __future__ import annotations

import torch

from slambench.reference.tslam.geometry.camera import PinholeCamera
from slambench.reference.tslam.geometry.se3 import so3_hat


def reprojection_residuals(cam: PinholeCamera, R: torch.Tensor, t: torch.Tensor,
                           X: torch.Tensor, z: torch.Tensor, mask: torch.Tensor):
    """R (K, 3, 3), t (K, 3) world->camera; X (L, 3) world points;
    z (L, K, 2) pixel observations; mask (L, K) visibility.

    Returns r (L, K, 2), J_pose (L, K, 2, 6), J_point (L, K, 2, 3) and
    ok (L, K).  The pose Jacobian is for a LEFT increment
    T_k <- exp(xi) T_k, the point Jacobian for X_l directly; ``ok`` drops
    points behind a camera, and their rows are zero.
    """
    pc = torch.einsum("kij,lj->lki", R, X) + t[None]   # (L, K, 3)
    zc = pc[..., 2]
    ok = mask & (zc > 1e-4)
    zs = torch.where(ok, zc, torch.ones_like(zc))
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    r = torch.stack([u, v], dim=-1) - z
    r = torch.where(ok[..., None], r, torch.zeros_like(r))

    inv_z = 1.0 / zs
    x_z = pc[..., 0] * inv_z
    y_z = pc[..., 1] * inv_z
    zero = torch.zeros_like(zc)
    J_proj = torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * x_z * inv_z], dim=-1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * y_z * inv_z], dim=-1),
    ], dim=-2)                                          # (L, K, 2, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    J_pc_pose = torch.cat([eye, -so3_hat(pc)], dim=-1)  # (L, K, 3, 6)
    J_pose = J_proj @ J_pc_pose
    J_point = torch.einsum("lkab,kbc->lkac", J_proj, R)  # d pc / d X = R_k
    okf = ok[..., None, None].to(pc.dtype)
    return r, J_pose * okf, J_point * okf, ok
