"""Trajectory evaluation: Umeyama alignment, ATE RMSE and RPE (mirrors
``tinyslam_tpu/utils/evaluation.py``; numpy only).  A monocular
trajectory has an arbitrary scale, so its ATE is Sim(3)-aligned."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning est -> gt, both (N, 3) matched
    positions.  Returns (s, R, t) with gt ~ s * R @ est + t."""
    mu_e, mu_g = est.mean(axis=0), gt.mean(axis=0)
    ec, gc = est - mu_e, gt - mu_g
    cov = gc.T @ ec / len(est)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_e = (ec * ec).sum() / len(est)
    s = float(np.trace(np.diag(d) @ S) / var_e) if with_scale else 1.0
    return s, R, mu_g - s * R @ mu_e


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after optional Umeyama alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if est.shape != gt.shape or est.ndim != 2:
        raise ValueError(f"shapes {est.shape} and {gt.shape} differ or are not (N, 3)")
    if align and len(est) >= 3:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=-1)
    return float(np.sqrt(np.mean(err * err)))


def rpe(est_poses: list[tuple[np.ndarray, np.ndarray]],
        gt_poses: list[tuple[np.ndarray, np.ndarray]],
        delta: int = 1) -> tuple[float, float]:
    """Relative pose error over a frame delta.  Poses are world->camera
    (R, t) pairs.  Returns (trans_rmse, rot_rmse_deg); NaN for lists
    shorter than ``delta`` + 1."""
    def rel(poses, i, j):
        Ri, ti = poses[i]
        Rj, tj = poses[j]
        R = Rj @ Ri.T
        return R, tj - R @ ti

    terrs, rerrs = [], []
    n = min(len(est_poses), len(gt_poses))
    for i in range(n - delta):
        Re, te = rel(est_poses, i, i + delta)
        Rg, tg = rel(gt_poses, i, i + delta)
        dR = Re @ Rg.T
        dt = te - dR @ tg
        terrs.append(np.linalg.norm(dt))
        c = np.clip((np.trace(dR) - 1) / 2, -1, 1)
        rerrs.append(np.degrees(np.arccos(c)))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(
        np.sqrt(np.mean(np.square(rerrs))))
