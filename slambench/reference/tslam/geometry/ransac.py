"""Batched LO-RANSAC for two-view relative pose, its manifold polish and
the cheirality choice among E's four poses (mirrors
``tinyslam_tpu/geometry/ransac.py``).

All hypotheses are drawn up front and solved as one batch, scored as one
(S, N) Sampson evaluation and reduced with argmax; the draws are an
argument (uniforms in [0, 1)), so that a caller, or a test holding the
port against the JAX package's ``jax.random`` streams, controls them.
"""

from __future__ import annotations

import torch

from slambench.reference.tslam.geometry.epipolar import (
    decompose_essential,
    depths,
    eight_point_essential,
    sampson_error,
    triangulate,
)
from slambench.reference.tslam.geometry.se3 import se3_identity, so3_exp, so3_hat
from slambench.reference.tslam.types import row


def sample_indices(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Map uniforms u (..., S) in [0, 1) to indices of ``valid``'s true
    entries, uniformly: valid entries are stably partitioned to the front
    and ``floor(u * count)`` picks among them (the reference's sampler;
    with no valid entry it picks index ``order[0]``)."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    count = torch.clamp_min(valid.sum(dtype=torch.int32), 1)
    k = torch.minimum((u * count).to(torch.int32), count - 1)
    return order[k.long()]


def lo_ransac(hyps, score, refit, valid, thresh2: float, wide2: float,
              refine_iters: int, lo_candidates: int):
    """The LO-RANSAC shared by the E (8- and 5-point) and H estimators.

    hyps (S, 3, 3) minimal hypotheses; score(models) -> (B, N) squared
    errors; refit(weights (k, N)) -> (k, 3, 3).  Hypotheses are ranked by
    a widened-threshold vote (ties to the lowest index), the top
    ``lo_candidates`` refit ``refine_iters`` times on their wide inliers,
    and the pool's best tight-threshold vote wins (first maximum).
    Returns (model (3, 3), inliers (N,), num_inliers ())."""
    errs = score(hyps)
    errs = torch.where(torch.isfinite(errs), errs, torch.full_like(errs, 1e9))
    wide_scores = ((errs < wide2) & valid).sum(-1, dtype=torch.int32)
    topk = torch.sort(-wide_scores, stable=True).indices[:lo_candidates]
    pool = [hyps[topk]]
    err_k = errs[topk]
    for _ in range(refine_iters):
        w = ((err_k < wide2) & valid).to(hyps.dtype)
        model = refit(w)
        err_k = score(model)
        pool.append(model)
    pool = torch.cat(pool, dim=0)
    err_pool = score(pool)
    err_pool = torch.where(torch.isfinite(err_pool), err_pool, torch.full_like(err_pool, 1e9))
    tight = ((err_pool < thresh2) & valid).sum(-1, dtype=torch.int32)
    best = row(pool, torch.argmax(tight))
    inliers = (score(best[None])[0] < thresh2) & valid
    return best, inliers, inliers.sum(dtype=torch.int32)


def ransac_essential(u: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                     valid: torch.Tensor, inlier_threshold: float = 2e-3,
                     refine_iters: int = 2, lo_candidates: int = 16) -> dict:
    """Essential-matrix LO-RANSAC with minimal 8-point hypotheses.

    u (S, m) uniforms draw S samples of m correspondences (the reference
    draws ``jax.random.uniform(key, (num_hypotheses, sample_size))``);
    x1, x2 (N, 2) normalized correspondences; valid (N,).  Ranking uses a
    4x-distance threshold, the top ``lo_candidates`` are refit, the tight
    vote over the pool wins.  Returns dict with E, inliers, num_inliers.
    """
    thresh2 = inlier_threshold * inlier_threshold
    idx = sample_indices(u, valid)
    E = eight_point_essential(x1[idx], x2[idx])
    n = x1.shape[0]
    E_best, inliers, num = lo_ransac(
        E, lambda m: sampson_error(m, x1[None], x2[None]),
        lambda w: eight_point_essential(x1.expand(w.shape[0], n, 2),
                                        x2.expand(w.shape[0], n, 2), w),
        valid, thresh2, 16.0 * thresh2, refine_iters, lo_candidates)
    return {"E": E_best, "inliers": inliers, "num_inliers": num}


def _tangent_basis(t: torch.Tensor):
    """Orthonormal (b1, b2) perpendicular to t, branch-free."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    ref = torch.where(t[0].abs() < 0.9, ex, ey)
    b1 = torch.linalg.cross(t, ref)
    b1 = b1 / torch.clamp_min(torch.linalg.norm(b1), 1e-9)
    return b1, torch.linalg.cross(t, b1)


def refine_relative_pose(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                         x2: torch.Tensor, valid: torch.Tensor,
                         inlier_threshold: float = 2e-3, iters: int = 10,
                         damping: float = 1e-6):
    """Gauss-Newton on the 5-DoF essential manifold (rotation, unit
    translation direction), minimizing the Cauchy-weighted signed Sampson
    distance of E(R, t) = [t]_x R.  The parameters are a left rotation
    increment and steps along two directions perpendicular to t, and the
    (N, 5) Jacobian at zero is analytic (the reference takes it by
    ``jax.jacfwd``).  Returns (R, t)."""
    thresh2 = inlier_threshold * inlier_threshold
    h1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    h2 = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    eye3 = torch.eye(3, dtype=x1.dtype, device=x1.device)
    eye5 = torch.eye(5, dtype=x1.dtype, device=x1.device)
    w_valid = valid.to(x1.dtype)

    for _ in range(iters):
        b1, b2 = _tangent_basis(t)
        nt = torch.clamp_min(torch.linalg.norm(t), 1e-9)
        E = so3_hat(t) @ R
        # dE/dp: [t]_x [e_k]_x R for the rotation, [b / |t|]_x R for t
        # (b is perpendicular to t, so that is the derivative of the
        # normalized t + p b).
        dE = torch.cat([so3_hat(t) @ so3_hat(eye3) @ R,
                        so3_hat(torch.stack([b1, b2]) / nt) @ R])      # (5, 3, 3)
        Ex1, Etx2 = h1 @ E.T, h2 @ E                                  # (N, 3)
        dEx1 = torch.einsum("kij,nj->kni", dE, h1)                     # (5, N, 3)
        dEtx2 = torch.einsum("kji,nj->kni", dE, h2)
        num = (h2 * Ex1).sum(-1)
        dnum = (h2 * dEx1).sum(-1)                                     # (5, N)
        den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        dden = 2.0 * (Ex1[:, 0] * dEx1[..., 0] + Ex1[:, 1] * dEx1[..., 1]
                      + Etx2[:, 0] * dEtx2[..., 0] + Etx2[:, 1] * dEtx2[..., 1])
        live = den > 1e-12
        sd = torch.sqrt(torch.clamp_min(den, 1e-12))
        r = num / sd
        J = (dnum / sd - torch.where(live, 0.5 * r / (sd * sd), 0.0) * dden).T   # (N, 5)
        w = w_valid / (1.0 + (r * r) / thresh2)
        Jw = J * w[:, None]
        p = -torch.linalg.solve_ex(Jw.T @ J + damping * eye5, Jw.T @ r)[0]
        tn = t + p[3] * b1 + p[4] * b2
        R, t = so3_exp(p[:3]) @ R, tn / torch.clamp_min(torch.linalg.norm(tn), 1e-9)
    return R, t


def cheirality_choice(Rs: torch.Tensor, ts: torch.Tensor, x1: torch.Tensor,
                      x2: torch.Tensor, inliers: torch.Tensor) -> dict:
    """Among candidate poses (C, 3, 3), (C, 3) of camera 2 (camera 1 is
    [I|0]), the one whose triangulations of the inliers lie in front of
    both cameras most often (first maximum).  Returns its index ``best``,
    R, t, points (N, 3), good (N,) and votes."""
    R_id, t_id = se3_identity((Rs.shape[0],), dtype=x1.dtype, device=x1.device)
    X = triangulate(R_id, t_id, x1, Rs, ts, x2)             # (C, N, 3)
    good = (X[..., 2] > 0) & (depths(Rs, ts, X) > 0) & inliers
    votes = good.sum(-1, dtype=torch.int32)
    best = torch.argmax(votes)
    return {"best": best, "R": row(Rs, best), "t": row(ts, best),
            "points": row(X, best), "good": row(good, best), "votes": row(votes, best)}


def recover_pose(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                 inliers: torch.Tensor) -> dict:
    """Cheirality disambiguation of E's candidates (R1, t), (R1, -t),
    (R2, t), (R2, -t).  Returns R, t (|t| = 1), points (N, 3) triangulated
    in camera 1, good (N,) and votes."""
    R1, R2, t = decompose_essential(E)
    out = cheirality_choice(torch.stack([R1, R1, R2, R2]),
                            torch.stack([t, -t, t, -t]), x1, x2, inliers)
    return {k: v for k, v in out.items() if k != "best"}
