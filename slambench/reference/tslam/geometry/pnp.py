"""PnP: robust Gauss-Newton on SE(3) from 3D-2D matches, and the
absolute-pose LO-RANSAC of relocalization (mirrors
``tinyslam_tpu/geometry/pnp.py``).

Fixed iteration counts, Huber IRLS weights and analytic 2x6 Jacobians; the
6x6 solve is ``torch.linalg.solve_ex``, which (unlike ``solve``) does not
read an error flag back to the host.  ``pnp_refine`` takes any leading
batch of poses and masks, so the relocalization polishes its 16 best
hypotheses as one batch, and of points and pixels too, so B camera
streams track as one; nothing in this module reads the device.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference.tslam.geometry.camera import PinholeCamera
from slambench.reference.tslam.geometry.linalg import det3, minimal_null_vector, polar_rotation3
from slambench.reference.tslam.geometry.se3 import se3_apply, se3_compose, se3_exp, so3_hat
from slambench.reference.tslam.types import row


def _residual_jacobian(cam: PinholeCamera, R, t, X, uv):
    """Residuals r = project(R X + t) - uv and Jacobians wrt a LEFT update
    T <- exp(xi) T.  R (..., 3, 3), t (..., 3), X (..., N, 3) and uv
    (..., N, 2), each batch broadcasting against the poses'.  Returns
    r (..., N, 2), J (..., N, 2, 6), front (..., N) mask."""
    pc = se3_apply(R[..., None, :, :], t[..., None, :], X)
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

    X (..., N, 3) world points; uv (..., N, 2) pixels; valid (..., N); R0
    (..., 3, 3), t0 (..., 3) the initial world->camera poses.  A leading
    batch refines several poses at once: the relocalization's hypotheses
    over one shared X and uv, or B sequences, each with its own points,
    pixels and pose.  Returns dict with R, t, inliers (..., N), rmse (...),
    num_inliers (...) int32 -- all tensors, nothing read back.
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
        Jw = J * w[..., None, None]
        H = torch.einsum("...nik,...nil->...kl", Jw, J)
        g = torch.einsum("...nik,...ni->...k", Jw, r)
        H = H + damping * eye6 * (1.0 + torch.diagonal(H, dim1=-2, dim2=-1))[..., None, :]
        delta = -torch.linalg.solve_ex(H, g)[0]
        dR, dt = se3_exp(delta)
        return se3_compose(dR, dt, R, t)

    R, t = R0, t0
    for _ in range(iters):
        R, t = gn_step(R, t, valid)

    r, _, front = _residual_jacobian(cam, R, t, X, uv)
    err = torch.linalg.norm(r, dim=-1)
    keep = valid & front & (err < inlier_px)
    keep = torch.where(keep.sum(-1, keepdim=True) >= 6, keep, valid)
    for _ in range(final_iters):
        R, t = gn_step(R, t, keep)

    r, _, front = _residual_jacobian(cam, R, t, X, uv)
    err = torch.linalg.norm(r, dim=-1)
    inliers = valid & front & (err < inlier_px)
    n_in = torch.clamp_min(inliers.to(torch.float32).sum(-1), 1.0)
    rmse = torch.sqrt(torch.where(inliers, err * err, torch.zeros_like(err)).sum(-1) / n_in)
    return {"R": R, "t": t, "inliers": inliers, "rmse": rmse,
            "num_inliers": inliers.sum(-1, dtype=torch.int32)}


def _dlt_pose(cam: PinholeCamera, X: torch.Tensor, uv: torch.Tensor,
              w: torch.Tensor):
    """Weighted DLT absolute pose from >= 6 3D-2D matches, batched.

    X (..., N, 3), uv (..., N, 2) pixels, w (..., N) weights (0 disables a
    row).  The world points are Hartley-normalized (weighted centroid at
    the origin, RMS radius sqrt(3)), the 2N x 12 system for P = [R|t] in
    normalized image coordinates is solved for its null vector (by
    ``minimal_null_vector``: relocalization's samples are minimal, N = 6,
    and it reads nothing back on the card), the 3x3
    block is projected onto SO(3) by the polar factor times its
    determinant (which also absorbs the null vector's sign), and the scale
    is trace(R^T Rp) / 3.  Degenerate samples give garbage poses that lose
    the vote: where the polar iteration has not converged to a rotation
    (a near-singular block; the reference's ``eigh`` null vector is then
    usually NaN already), the pose is NaN.  A non-rotation would otherwise
    fit every match as a general projective camera, refine to a perfect
    score and win.  Returns (R (..., 3, 3), t (..., 3)).
    """
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    wsum = torch.clamp_min(w.sum(-1), 1e-9)
    c = (X * w[..., None]).sum(-2) / wsum[..., None]
    r = torch.sqrt((((X - c[..., None, :]) ** 2).sum(-1) * w).sum(-1) / wsum)
    s = np.sqrt(3.0) / torch.clamp_min(r, 1e-9)
    Xn = (X - c[..., None, :]) * s[..., None, None]
    Xh = torch.cat([Xn, torch.ones_like(Xn[..., :1])], dim=-1)     # (..., N, 4)
    zeros = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zeros, -x[..., None] * Xh], dim=-1)
    rows_v = torch.cat([zeros, Xh, -y[..., None] * Xh], dim=-1)
    A = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], dim=-2)
    p = minimal_null_vector(A).reshape(*A.shape[:-2], 3, 4)
    Rp, tp = p[..., :3], p[..., 3]
    U = polar_rotation3(Rp)
    R = U * det3(U)[..., None, None]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    rotation = ((R.transpose(-1, -2) @ R - eye).abs().amax((-2, -1)) < 1e-3)[..., None, None]
    R = torch.where(rotation, R, torch.full_like(R, float("nan")))
    lam = torch.diagonal(R.transpose(-1, -2) @ Rp, dim1=-2, dim2=-1).sum(-1) / 3.0
    lam = torch.where(lam.abs() > 1e-12, lam, torch.full_like(lam, 1e-12))
    tn = tp / lam[..., None]
    # R (s (X - c)) + tn projects like R X + t with t = tn / s - R c.
    t = tn / s[..., None] - (R @ c[..., None])[..., 0]
    return R, t


def _project_err(cam: PinholeCamera, R, t, X, uv):
    """Pixel error (..., N) of X under (R, t) and the camera-frame depth."""
    pc = torch.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
    z = torch.clamp_min(pc[..., 2], 1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    return torch.linalg.norm(torch.stack([u, v], -1) - uv, dim=-1), pc[..., 2]


def pnp_ransac(cam: PinholeCamera, X: torch.Tensor, uv: torch.Tensor,
               valid: torch.Tensor, sample_idx: torch.Tensor,
               inlier_px: float = 6.0, refine_iters: int = 8,
               R_prior: torch.Tensor | None = None,
               t_prior: torch.Tensor | None = None, top_k: int = 16) -> dict:
    """Absolute-pose LO-RANSAC: batched DLT hypotheses, an inlier vote, and
    the ``top_k`` best polished by ``pnp_refine`` as one batch.

    X (N, 3), uv (N, 2) pixels, valid (N,); ``sample_idx`` (H, S) the
    minimal samples, indices of valid matches (the reference draws them
    with ``jax.random.categorical`` over the valid entries).  The optional
    stale pose (R_prior, t_prior) joins the pool as one more hypothesis.
    The top ``top_k`` votes (ties to the lowest index, as ``lax.top_k``)
    are each refined on their own voted inliers, re-collected once under
    the refined pose and refined again (``refine_iters`` + 4 iterations);
    the most final inliers win (first maximum).  Returns dict with R, t,
    inliers (N,) and num_inliers, rmse against the whole match set, and
    hypothesis_inliers (the winner's raw vote).
    """
    Rs, ts = _dlt_pose(cam, X[sample_idx], uv[sample_idx],
                       torch.ones(sample_idx.shape, dtype=X.dtype, device=X.device))
    if R_prior is not None:
        Rs = torch.cat([Rs, R_prior[None]], dim=0)
        ts = torch.cat([ts, t_prior[None]], dim=0)

    def inlier_mask(R, t):
        err, z = _project_err(cam, R, t, X, uv)
        return valid & (z > 1e-4) & (err < inlier_px)

    def at_least6(m, fallback):
        return torch.where(m.sum(-1, keepdim=True) >= 6, m, fallback)

    votes = inlier_mask(Rs, ts).sum(-1, dtype=torch.int32)
    top = torch.sort(votes, descending=True, stable=True).indices[:top_k]
    R0, t0 = Rs[top], ts[top]
    m0 = at_least6(inlier_mask(R0, t0), valid)
    o = pnp_refine(cam, X, uv, m0, R0, t0, iters=refine_iters, inlier_px=inlier_px)
    m1 = at_least6(inlier_mask(o["R"], o["t"]), m0)
    o = pnp_refine(cam, X, uv, m1, o["R"], o["t"], iters=4, inlier_px=inlier_px)
    nk = inlier_mask(o["R"], o["t"]).sum(-1, dtype=torch.int32)
    win = torch.argmax(nk)
    R_best, t_best = row(o["R"], win), row(o["t"], win)
    final = inlier_mask(R_best, t_best)
    err, _ = _project_err(cam, R_best, t_best, X, uv)
    n_in = torch.clamp_min(final.to(torch.float32).sum(), 1.0)
    return {
        "R": R_best, "t": t_best, "inliers": final,
        "num_inliers": final.sum(dtype=torch.int32),
        "rmse": torch.sqrt(torch.where(final, err * err, torch.zeros_like(err)).sum() / n_in),
        "hypothesis_inliers": row(votes, row(top, win)),
    }
