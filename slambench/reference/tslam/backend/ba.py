"""Schur-complement Levenberg-Marquardt bundle adjustment (mirrors
``tinyslam_tpu/backend/ba.py:bundle_adjust, _bundle_adjust_core``).

The sparse normal equations

    [ U   W ] [dc]   [ gc ]
    [ W^T V ] [dp] = [ gp ]

are solved by eliminating the 3x3 landmark blocks V with a closed-form
inverse, which leaves the camera system S dc = b with
S = U - W V^-1 W^T and b = gc - W V^-1 gp, one (6K x 6K) Cholesky.

The JAX package runs the LM iterations as a ``lax.scan`` in a
landmarks-last layout (for the TPU's lanes); here they are a Python loop
over ``max_iters`` in the (L, K, ...) layout of ``reprojection_residuals``,
with every accept or reject a ``torch.where`` on the device, so nothing is
read back to the host.  Where ``jnp.linalg.cholesky`` returns NaN for a
matrix that is not positive definite (and the NaN step is then rejected),
``torch.linalg.cholesky_ex`` returns a partial factor and ``info > 0``; the
accept rule tests ``info == 0``.
"""

from __future__ import annotations

import torch

from slambench.reference.tslam.backend.residuals import reprojection_residuals
from slambench.reference.tslam.geometry.camera import PinholeCamera
from slambench.reference.tslam.geometry.se3 import se3_compose, se3_exp


def _identity(x):
    return x


def ba_normal_blocks(cam, R, t, X, z, mask, huber: float):
    """The BA normal-equation blocks with Huber IRLS weights.

    Returns U (K, 6, 6), gc (K, 6), V (L, 3, 3), gp (L, 3), W (L, K, 6, 3),
    the robust cost and the count of active residuals.  U, gc, cost and
    the count are sums over landmarks (what a distributed BA reduces
    across landmark shards); V, gp and W stay per landmark.
    """
    r, Jc, Jp, ok = reprojection_residuals(cam, R, t, X, z, mask)
    err = torch.sqrt((r * r).sum(-1) + 1e-18)          # (L, K)
    w = torch.where(err > huber, huber / torch.clamp_min(err, 1e-9),
                    torch.ones_like(err)) * ok.to(r.dtype)
    wJc = Jc * w[..., None, None]
    wJp = Jp * w[..., None, None]
    U = torch.einsum("lkia,lkib->kab", wJc, Jc)
    gc = -torch.einsum("lkia,lki->ka", wJc, r)
    V = torch.einsum("lkia,lkib->lab", wJp, Jp)
    gp = -torch.einsum("lkia,lki->la", wJp, r)
    W = torch.einsum("lkia,lkib->lkab", wJc, Jp)
    e = torch.where(ok, err, torch.zeros_like(err))
    rho = torch.where(e > huber, huber * (e - 0.5 * huber), 0.5 * e * e)
    cost = (rho * ok.to(err.dtype)).sum()
    num_ok = ok.sum(dtype=torch.int32)
    return U, gc, V, gp, W, cost, num_ok


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) blocks by the adjugate: no LU
    and no error flag read back (``torch.linalg.inv`` checks one)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * (1.0 / det)[..., None, None]


def _damp(M: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Marquardt damping M + lam * (diag(M) + 1e-6) on each block."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    return M + lam * (torch.diag_embed(diag) + 1e-6 * eye)


def schur_reduce(U, gc, V, gp, W, lam, pose_free, preduce=_identity):
    """Eliminate the landmarks: returns S (6K, 6K), b (6K,) and the damped
    landmark inverses Vinv (L, 3, 3).

    ``preduce`` sums landmark-summed quantities across landmark shards
    (the identity on one device).  U and gc must already be reduced.
    Poses with ``pose_free`` false are gauge-fixed: their rows and columns
    are projected out and their diagonal block is the identity.
    """
    K = U.shape[0]
    Ud = _damp(U, lam)
    # Absolute floor: bounds the step of weakly constrained landmarks.
    Vd = _damp(V, lam) + 1e-3 * torch.eye(3, dtype=V.dtype, device=V.device)
    Vinv = _inv3x3(Vd)

    T = torch.einsum("lkab,lbc->lkac", W, Vinv)         # (L, K, 6, 3)
    diag = torch.eye(K, dtype=U.dtype, device=U.device)[:, :, None, None]
    S = diag * Ud[:, None] - preduce(torch.einsum("lkac,lmbc->kmab", T, W))
    b = gc - preduce(torch.einsum("lkac,lc->ka", T, gp))

    free = pose_free.to(U.dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = S + diag * ((1.0 - free)[:, None, None, None]
                    * torch.eye(6, dtype=U.dtype, device=U.device))
    b = b * free[:, None]
    return S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K), b.reshape(6 * K), Vinv


def back_substitute(Vinv, W, gp, dc):
    """Landmark updates from the camera step: dp = Vinv (gp - W^T dc)."""
    rhs = gp - torch.einsum("lkab,ka->lb", W, dc)
    return torch.einsum("lab,lb->la", Vinv, rhs)


def bundle_adjust(cam: PinholeCamera, R: torch.Tensor, t: torch.Tensor,
                  X: torch.Tensor, z: torch.Tensor, mask: torch.Tensor,
                  pose_free: torch.Tensor, point_valid: torch.Tensor | None = None,
                  max_iters: int = 10, huber: float = 5.0, lam0: float = 1e-3,
                  lam_up: float = 10.0, lam_down: float = 0.5) -> dict:
    """Levenberg-Marquardt BA with accept/reject damping control over a
    fixed number of iterations.

    R (K, 3, 3), t (K, 3), X (L, 3), z (L, K, 2), mask (L, K) bool,
    pose_free (K,) bool (false = gauge-fixed), point_valid (L,) bool.
    Returns dict with R, t, X, cost, initial_cost and lam.
    """
    if point_valid is not None:
        mask = mask & point_valid[:, None]
    return _bundle_adjust_core(cam, R, t, X, z, mask, pose_free, max_iters,
                               huber, lam0, lam_up, lam_down)


def _bundle_adjust_core(cam, R, t, X, z, mask, pose_free, max_iters: int,
                        huber: float, lam0: float, lam_up: float,
                        lam_down: float, preduce=_identity) -> dict:
    """The LM loop.  With a cross-shard sum as ``preduce``, X/z/mask are
    one landmark shard: pose-side sums cross the shards, landmark updates
    stay local, and every shard runs the same (6K x 6K) solve."""

    def blocks(R_, t_, X_):
        U, gc, V, gp, W, cost, num_ok = ba_normal_blocks(cam, R_, t_, X_, z,
                                                         mask, huber)
        return (preduce(U), preduce(gc), V, gp, W, preduce(cost),
                preduce(num_ok))

    K = R.shape[0]
    eye = torch.eye(6 * K, dtype=X.dtype, device=X.device)
    n_shards = preduce(torch.ones((), dtype=torch.int32, device=X.device))
    *_, cost0, num_ok0 = blocks(R, t, X)
    shed_min = (0.95 * num_ok0.to(torch.float32)).to(torch.int32)
    lam = torch.full((), lam0, dtype=X.dtype, device=X.device)
    cost_k, num_ok = cost0, num_ok0
    for _ in range(max_iters):
        U, gc, V, gp, W, cost, _ = blocks(R, t, X)
        S, b, Vinv = schur_reduce(U, gc, V, gp, W, lam, pose_free, preduce)
        L_chol, info = torch.linalg.cholesky_ex(S + 1e-8 * eye)
        y = torch.linalg.solve_triangular(L_chol, b[:, None], upper=False)
        dc = torch.linalg.solve_triangular(L_chol.T, y, upper=True).reshape(K, 6)
        dp = back_substitute(Vinv, W, gp, dc)

        dR, dt = se3_exp(dc)
        R_new, t_new = se3_compose(dR, dt, R, t)
        X_new = X + dp
        *_, cost_new, num_ok_new = blocks(R_new, t_new, X_new)
        # Shedding guard: a divergent step that pushes points behind the
        # cameras empties the mask and scores a spuriously low cost.  Allow
        # 2 residuals of slack a step, never below 95% of the initial set.
        shed_floor = torch.maximum(num_ok - 2, shed_min)
        accept = ((info == 0) & torch.isfinite(cost_new) & (cost_new < cost)
                  & (num_ok_new >= shed_floor)
                  & (preduce(torch.isfinite(X_new).all().to(torch.int32)) == n_shards)
                  & torch.isfinite(t_new).all())
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        X = torch.where(accept, X_new, X)
        lam = torch.clamp(torch.where(accept, lam * lam_down, lam * lam_up),
                          1e-9, 1e6)
        cost_k = torch.where(accept, cost_new, cost)
        num_ok = torch.where(accept, num_ok_new, num_ok)
    return {"R": R, "t": t, "X": X, "cost": cost_k, "initial_cost": cost0,
            "lam": lam}
