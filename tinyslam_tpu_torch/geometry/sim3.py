"""Sim(3) Lie-group operations (mirrors ``tinyslam_tpu/geometry/sim3.py``).

A similarity S = (R, t, s) acts on points as X -> s R X + t; monocular SLAM
closes loops over Sim(3) because odometry drifts in scale, which SE(3)
edges cannot absorb.  Tangent vectors xi are (..., 7) ordered [rho (trans
3), phi (rot 3), sigma (log scale 1)].  exp uses the W matrix that
generalizes SE(3)'s left Jacobian; log solves the 3x3 W system for rho.

As in ``se3.py``, small-value branches are ``torch.where`` selections with
safe denominators, so nothing is read back to the host and no NaN of an
unselected branch reaches the selected one.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.geometry.se3 import _matvec, so3_exp, so3_hat, so3_log


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W(phi, sigma) with t = W @ rho in ``sim3_exp``.

    Four regions of closed forms (Sophus sim3 calc_W), selected without
    branching: theta and sigma both finite (the full trigonometric form),
    small theta (sigma-only forms), small sigma (SE(3)'s left Jacobian,
    C -> 1), both small (Taylor constants, exact in value and in the first
    derivative where the pose graph needs it).
    """
    theta2 = (phi * phi).sum(-1)
    small_t = theta2 < 1e-10
    small_s = sigma.abs() < 1e-5
    one = torch.ones_like(sigma)
    theta = torch.sqrt(torch.where(small_t, one, theta2))
    sig = torch.where(small_s, one, sigma)
    s = torch.exp(sigma)

    Om = so3_hat(phi)
    Om2 = Om @ Om
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Om.shape)

    # big sigma, big theta
    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    c_ = theta2 + sigma * sigma
    c_safe = torch.where(small_t & small_s, one, c_)
    C_big = (s - 1.0) / sig
    A_bb = (a_ * sigma + (1.0 - b_) * theta) / (theta * c_safe)
    B_bb = (C_big - ((b_ - 1.0) * sigma + a_ * theta) / c_safe) / theta2

    # big sigma, small theta
    A_bs = ((sigma - 1.0) * s + 1.0) / (sig * sig)
    B_bs = (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0) / (sig * sig * sig)

    # small sigma, big theta (SE(3) left Jacobian coefficients)
    A_sb = (1.0 - torch.cos(theta)) / theta2
    B_sb = (theta - torch.sin(theta)) / (theta2 * theta)

    # small sigma, small theta (Taylor)
    A_ss = torch.full_like(sigma, 0.5)
    B_ss = torch.full_like(sigma, 1.0 / 6.0)

    A = torch.where(small_s, torch.where(small_t, A_ss, A_sb),
                    torch.where(small_t, A_bs, A_bb))
    B = torch.where(small_s, torch.where(small_t, B_ss, B_sb),
                    torch.where(small_t, B_bs, B_bb))
    C = torch.where(small_s, 1.0 + 0.5 * sigma, C_big)
    return C[..., None, None] * I + A[..., None, None] * Om + B[..., None, None] * Om2


def sim3_identity(batch: tuple[int, ...] = (), dtype=torch.float32, device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3).clone()
    t = torch.zeros((*batch, 3), dtype=dtype, device=device)
    s = torch.ones(batch, dtype=dtype, device=device)
    return R, t, s


def sim3_exp(xi: torch.Tensor):
    """(..., 7) [rho, phi, sigma] -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return so3_exp(phi), _matvec(_sim3_W(phi, sigma), rho), torch.exp(sigma)


def sim3_log(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(R, t, s) -> (..., 7) [rho, phi, sigma].  ``solve_ex``, not
    ``solve``: the latter reads its error flag back on the card."""
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = torch.linalg.solve_ex(_sim3_W(phi, sigma), t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(a) o (b): apply b first, then a.  X -> sa Ra (sb Rb X + tb) + ta."""
    return Ra @ Rb, sa[..., None] * _matvec(Ra, tb) + ta, sa * sb


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * _matvec(Rt, t), s_inv


def sim3_apply(R, t, s, x) -> torch.Tensor:
    """Transform points x (..., 3):  s R x + t."""
    return s[..., None] * _matvec(R, x) + t


def sim3_from_se3(R, t):
    """Lift an SE(3) pose to Sim(3) with unit scale."""
    return R, t, torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)


def sim3_to_se3(R, t, s):
    """Project a world->camera Sim(3) pose to SE(3): x_cam = s R X + t has
    the camera centre of (R, t / s); the rescaled camera frame is not
    observable by a projective camera."""
    return R, t / s[..., None]
