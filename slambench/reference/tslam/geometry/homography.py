"""Homography estimation and decomposition, the planar half of the
two-view bootstrap (mirrors ``tinyslam_tpu/geometry/homography.py``).

A quasi-planar scene makes the essential matrix degenerate, so the
bootstrap estimates a homography H beside E and selects by inlier share:
batched 4-point DLT hypotheses, LO-RANSAC, and the Faugeras-Lustman
decomposition of a calibrated H into eight (R, t, n) candidates.

Convention: x2 ~ H x1 in normalized image coordinates; for a plane
n^T X = d in camera 1, H = R + t n^T / d where X2 = R X1 + t.
"""

from __future__ import annotations

import torch

from slambench.reference.tslam.geometry.epipolar import hartley_normalize, similarity3
from slambench.reference.tslam.geometry.linalg import det3, null_vector, svd3
from slambench.reference.tslam.geometry.ransac import cheirality_choice, lo_ransac, sample_indices
from slambench.reference.tslam.types import row


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def four_point_homography(x1: torch.Tensor, x2: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted, Hartley-normalized DLT homography (N >= 4), batched.
    x1, x2 (..., N, 2).  Returns (..., 3, 3) with unit Frobenius norm."""
    w = torch.ones_like(x1[..., 0]) if weights is None else weights
    x1n, c1, s1 = hartley_normalize(x1, w)
    x2n, c2, s2 = hartley_normalize(x2, w)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], dim=-1)
    r2 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    h = null_vector(A)
    Hn = h.reshape(*h.shape[:-1], 3, 3)
    # x2n = Hn x1n with x_in = T_i x_i  =>  H = T2^-1 Hn T1.
    zz, oo = torch.zeros_like(s2), torch.ones_like(s2)
    T2i = torch.stack([
        torch.stack([1.0 / s2, zz, c2[..., 0]], dim=-1),
        torch.stack([zz, 1.0 / s2, c2[..., 1]], dim=-1),
        torch.stack([zz, zz, oo], dim=-1),
    ], dim=-2)
    H = T2i @ Hn @ similarity3(c1, s1)
    return H / torch.clamp_min(torch.linalg.norm(H, dim=(-2, -1), keepdim=True), 1e-12)


def homography_transfer_error(H: torch.Tensor, x1: torch.Tensor,
                              x2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared transfer error (..., N) in normalized coordinates.
    The inverse is ``inv_ex`` of H + 1e-12 I: a singular hypothesis gets
    non-finite errors and loses the vote, nothing is read back."""
    h1, h2 = _homog(x1), _homog(x2)
    Hx1 = torch.einsum("...ij,...nj->...ni", H, h1)
    Hinv = torch.linalg.inv_ex(H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device))[0]
    Hix2 = torch.einsum("...ij,...nj->...ni", Hinv, h2)

    def dehomog(p):
        w = p[..., 2:3]
        return p[..., :2] / torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))

    e12 = ((dehomog(Hx1) - x2) ** 2).sum(-1)
    e21 = ((dehomog(Hix2) - x1) ** 2).sum(-1)
    return e12 + e21


def ransac_homography(u: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                      valid: torch.Tensor, inlier_threshold: float = 2e-3,
                      refine_iters: int = 2, lo_candidates: int = 8) -> dict:
    """LO-RANSAC for H, structured as ``ransac_essential``.  ``u`` (S, 4)
    uniforms draw the samples (the reference: ``jax.random.uniform(key,
    (num_hypotheses, 4))``).  Returns dict with H, inliers, num_inliers."""
    thresh2 = 2.0 * inlier_threshold * inlier_threshold   # two error terms
    idx = sample_indices(u, valid)
    H = four_point_homography(x1[idx], x2[idx])
    n = x1.shape[0]
    H_best, inliers, num = lo_ransac(
        H, lambda m: homography_transfer_error(m, x1[None], x2[None]),
        lambda w: four_point_homography(x1.expand(w.shape[0], n, 2),
                                        x2.expand(w.shape[0], n, 2), w),
        valid, thresh2, 16.0 * thresh2, refine_iters, lo_candidates)
    return {"H": H_best, "inliers": inliers, "num_inliers": num}


def decompose_homography(H: torch.Tensor):
    """Faugeras-Lustman decomposition of a calibrated homography.

    Returns (Rs (8, 3, 3), ts (8, 3), ns (8, 3)): the four sign cases
    (e1, e3) of the d' = +d2 family, then the four of d' = -d2, in the
    reference's order.  Cheirality and support choose downstream."""
    u, lam, vt = svd3(H)
    s = det3(u) * det3(vt)
    a = lam[0] / lam[1]
    c = lam[2] / lam[1]
    denom = torch.clamp_min(a * a - c * c, 1e-12)
    x1m = torch.sqrt(torch.clamp_min((a * a - 1.0) / denom, 0.0))
    x3m = torch.sqrt(torch.clamp_min((1.0 - c * c) / denom, 0.0))
    signs = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]],
                         dtype=H.dtype, device=H.device)
    x1v = torch.cat([signs[:, 0], signs[:, 0]]) * x1m           # (8,)
    x3v = torch.cat([signs[:, 1], signs[:, 1]]) * x3m
    plus = torch.arange(8, device=H.device) < 4                 # d' = +d2
    zero, one = torch.zeros_like(x1v), torch.ones_like(x1v)
    sin_ = torch.where(plus, (a - c) * x1v * x3v, (a + c) * x1v * x3v)
    cos_ = torch.where(plus, a * x3v * x3v + c * x1v * x1v,
                       a * x3v * x3v - c * x1v * x1v)
    Rp = torch.where(plus[:, None, None], torch.stack([
        torch.stack([cos_, zero, -sin_], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([sin_, zero, cos_], -1)], -2), torch.stack([
        torch.stack([cos_, zero, sin_], -1),
        torch.stack([zero, -one, zero], -1),
        torch.stack([sin_, zero, -cos_], -1)], -2))
    tp = torch.where(plus[:, None],
                     (a - c) * torch.stack([x1v, zero, -x3v], -1),
                     (a + c) * torch.stack([x1v, zero, x3v], -1))
    npl = torch.stack([x1v, zero, x3v], -1)
    Rs = s * u @ Rp @ vt
    ts = torch.einsum("ij,cj->ci", u, tp)
    ns = torch.einsum("ij,cj->ci", vt.T, npl)
    return Rs, ts, ns


def recover_pose_homography(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                            inliers: torch.Tensor) -> dict:
    """The candidate of ``decompose_homography`` with the most inliers in
    front of both cameras (first maximum), |t| = 1.  Returns R, t, n,
    points (N, 3) in camera 1, good (N,) and votes."""
    Rs, ts, ns = decompose_homography(H)
    ts = ts / torch.clamp_min(torch.linalg.norm(ts, dim=-1, keepdim=True), 1e-9)
    out = cheirality_choice(Rs, ts, x1, x2, inliers)
    out["n"] = row(ns, out.pop("best"))
    return out
