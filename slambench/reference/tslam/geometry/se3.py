"""SO(3)/SE(3) Lie-group operations (mirrors ``tinyslam_tpu/geometry/se3.py``).

Poses are (R, t) pairs: R (..., 3, 3), t (..., 3).  Tangent vectors xi are
(..., 6) ordered [upsilon (trans), omega (rot)].  Small-angle branches are
``torch.where`` selections, so nothing here reads a value back to the host.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _eye(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = so3_hat(w / theta[..., None])
    s = torch.sin(theta)[..., None, None]
    c1 = (1.0 - torch.cos(theta))[..., None, None]
    I = _eye(w, K.shape)
    R_full = I + s * K + c1 * (K @ K)
    H = so3_hat(w)
    R_small = I + H + 0.5 * (H @ H)
    small = (theta2 < 1e-12)[..., None, None]
    return torch.where(small, R_small, R_full)


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) unit quaternion (w, x, y, z), w >= 0, by
    Shepperd's method with all four candidates computed and the largest
    selected."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tw = 1.0 + r00 + r11 + r22
    tx = 1.0 + r00 - r11 - r22
    ty = 1.0 - r00 + r11 - r22
    tz = 1.0 - r00 - r11 + r22
    i_max = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)

    def s_of(v):
        return torch.sqrt(torch.clamp_min(v, _EPS)) * 2.0

    s = s_of(tw)
    q = torch.stack([0.25 * s, (r21 - r12) / s, (r02 - r20) / s,
                     (r10 - r01) / s], dim=-1)
    s = s_of(tx)
    q1 = torch.stack([(r21 - r12) / s, 0.25 * s, (r01 + r10) / s,
                      (r02 + r20) / s], dim=-1)
    s = s_of(ty)
    q2 = torch.stack([(r02 - r20) / s, (r01 + r10) / s, 0.25 * s,
                      (r12 + r21) / s], dim=-1)
    s = s_of(tz)
    q3 = torch.stack([(r10 - r01) / s, (r02 + r20) / s, (r12 + r21) / s,
                      0.25 * s], dim=-1)
    for i, qi in ((1, q1), (2, q2), (3, q3)):
        q = torch.where((i_max == i)[..., None], qi, q)
    q = q * torch.sign(q[..., 0:1] + _EPS)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle, via the quaternion."""
    q = rotation_to_quaternion(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    norm_qv = torch.linalg.norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(norm_qv, qw)
    scale = torch.where(norm_qv > 1e-7,
                        theta / torch.clamp_min(norm_qv, _EPS),
                        2.0 / torch.clamp_min(qw, _EPS))
    return qv * scale[..., None]


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V such that se3_exp translation = V @ upsilon."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    H = so3_hat(w)
    I = _eye(w, H.shape)
    a = ((1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))[..., None, None]
    b = ((theta - torch.sin(theta)) / (theta2 * theta + _EPS))[..., None, None]
    V_full = I + a * H + b * (H @ H)
    V_small = I + 0.5 * H + (H @ H) / 6.0
    small = (theta2 < 1e-12)[..., None, None]
    return torch.where(small, V_small, V_full)


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    H = so3_hat(w)
    I = _eye(w, H.shape)
    half = 0.5 * theta
    tan_half = torch.tan(half)
    cot = torch.where(tan_half.abs() > 1e-8, 1.0 / tan_half, 2.0 / theta)
    c = torch.where(
        theta2 > 1e-12,
        (1.0 / (theta2 + _EPS * _EPS)) * (1.0 - theta * cot / 2.0),
        torch.full_like(theta, 1.0 / 12.0),
    )[..., None, None]
    return I - 0.5 * H + c * (H @ H)


def se3_identity(batch: tuple[int, ...] = (), dtype=torch.float32,
                 device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3).clone()
    t = torch.zeros((*batch, 3), dtype=dtype, device=device)
    return R, t


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def se3_exp(xi: torch.Tensor):
    """(..., 6) [upsilon, omega] -> (R, t)."""
    v, w = xi[..., :3], xi[..., 3:]
    return so3_exp(w), _matvec(_so3_left_jacobian(w), v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (..., 6) [upsilon, omega]."""
    w = so3_log(R)
    v = _matvec(_so3_left_jacobian_inv(w), t)
    return torch.cat([v, w], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): apply b first, then a."""
    return Ra @ Rb, _matvec(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se3_apply(R, t, x) -> torch.Tensor:
    """Transform points x (..., 3) by one pose (or a broadcast batch)."""
    return _matvec(R, x) + t
