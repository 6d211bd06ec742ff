"""PnP pose tracking: robust Gauss-Newton on SE(3) from 3D-2D matches
(mirrors ``tinyslam_tpu/geometry/pnp.py:_residual_jacobian, pnp_refine``).

Fixed iteration counts, Huber IRLS weights and analytic 2x6 Jacobians; the
6x6 solve is ``torch.linalg.solve_ex``, which (unlike ``solve``) does not
read an error flag back to the host.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.geometry.se3 import se3_apply, se3_compose, se3_exp, so3_hat


def _residual_jacobian(cam: PinholeCamera, R, t, X, uv):
    """Residuals r = project(R X + t) - uv and Jacobians wrt a LEFT update
    T <- exp(xi) T.  Returns r (N, 2), J (N, 2, 6), front (N,) mask."""
    pc = se3_apply(R, t, X)
    z = pc[..., 2]
    front = z > 1e-4
    zs = torch.where(front, z, torch.ones_like(z))
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    r = torch.stack([u, v], dim=-1) - uv

    inv_z = 1.0 / zs
    x_z = pc[..., 0] * inv_z
    y_z = pc[..., 1] * inv_z
    zero = torch.zeros_like(z)
    J_proj = torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * x_z * inv_z], dim=-1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * y_z * inv_z], dim=-1),
    ], dim=-2)                                         # (N, 2, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    J_pc = torch.cat([eye, -so3_hat(pc)], dim=-1)      # (N, 3, 6)
    return r, J_proj @ J_pc, front


def pnp_refine(cam: PinholeCamera, X, uv, valid, R0, t0, iters: int = 8,
               huber_px: float = 4.0, damping: float = 1e-4,
               inlier_px: float = 4.0, final_iters: int = 4) -> dict:
    """Two-stage Levenberg-damped Gauss-Newton PnP.

    Stage 1: ``iters`` Huber-weighted iterations over all observations.
    Stage 2: hard-reject residuals above ``inlier_px`` (unless fewer than 6
    survive) and run ``final_iters`` clean iterations on the survivors.

    X (N, 3) world points; uv (N, 2) pixels; valid (N,); R0, t0 the initial
    world->camera pose.  Returns dict with R, t, inliers (N,), rmse (),
    num_inliers () int32 -- all tensors, nothing read back.
    """
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)

    def gn_step(R, t, mask):
        r, J, front = _residual_jacobian(cam, R, t, X, uv)
        ok = mask & front
        err = torch.linalg.norm(r, dim=-1)
        w_rob = torch.where(err > huber_px,
                            huber_px / torch.clamp_min(err, 1e-9),
                            torch.ones_like(err))
        w = w_rob * ok.to(torch.float32)
        Jw = J * w[:, None, None]
        H = torch.einsum("nik,nil->kl", Jw, J)
        g = torch.einsum("nik,ni->k", Jw, r)
        H = H + damping * eye6 * (1.0 + torch.diagonal(H))
        delta = -torch.linalg.solve_ex(H, g)[0]
        dR, dt = se3_exp(delta)
        return se3_compose(dR, dt, R, t)

    R, t = R0, t0
    for _ in range(iters):
        R, t = gn_step(R, t, valid)

    r, _, front = _residual_jacobian(cam, R, t, X, uv)
    err = torch.linalg.norm(r, dim=-1)
    keep = valid & front & (err < inlier_px)
    keep = torch.where(keep.sum() >= 6, keep, valid)
    for _ in range(final_iters):
        R, t = gn_step(R, t, keep)

    r, _, front = _residual_jacobian(cam, R, t, X, uv)
    err = torch.linalg.norm(r, dim=-1)
    inliers = valid & front & (err < inlier_px)
    n_in = torch.clamp_min(inliers.to(torch.float32).sum(), 1.0)
    rmse = torch.sqrt(torch.where(inliers, err * err, torch.zeros_like(err)).sum() / n_in)
    return {"R": R, "t": t, "inliers": inliers, "rmse": rmse,
            "num_inliers": inliers.sum(dtype=torch.int32)}
