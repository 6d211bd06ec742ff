"""Oriented FAST-16 corner scoring as dense maps: the plain PyTorch version
of the fused FAST kernel (mirrors ``tinyslam_tpu/ops/fast.py``).

``fast_maps`` is what ``ops/fast_cuda.py`` computes in one CUDA launch:
raw score, 3x3-NMS score, the 15x15 centroid moments and the 7-tap blur.
Every sum here runs in a fixed order, one rounded add at a time, and the
kernel follows the same order, so the two agree bit for bit on the card.
All stencils clamp to the image edge; NMS treats pixels outside the image
as -inf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slambench.reference.tslam.ops.image import edge_pad, gaussian_blur

# The 16-point Bresenham circle of radius 3, in circular order starting from
# (dx, dy) = (0, -3) going clockwise.
RING16: tuple[tuple[int, int], ...] = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

_MASK16 = 0xFFFF
MOMENT_RADIUS = 7


def _rot16(x: torch.Tensor, c: int) -> torch.Tensor:
    """Rotate the low 16 bits right by c (bit i <- bit (i+c)%16)."""
    return ((x >> c) | (x << (16 - c))) & _MASK16


def detect_streak(x: torch.Tensor, n: int) -> torch.Tensor:
    """Nonzero iff the 16-bit mask has a circular run of >= n set bits.

    Bit i of the result is set iff bits i..i+n-1 (mod 16) are all set; runs
    of length 2k come from run_k & rot(run_k, k), and n from its binary
    decomposition (run_{a+b} = run_a & rot(run_b, a)).
    """
    assert 1 <= n <= 16
    x = x & _MASK16
    pow_runs = {1: x}
    k = 1
    while k * 2 <= n:
        pow_runs[k * 2] = pow_runs[k] & _rot16(pow_runs[k], k)
        k *= 2
    run = None
    length = 0
    for p in sorted(pow_runs, reverse=True):
        if length + p <= n:
            run = pow_runs[p] if run is None else run & _rot16(pow_runs[p], length)
            length += p
    assert length == n
    return run


def detect_streak_16(x: torch.Tensor) -> torch.Tensor:
    """The exact n=12 variant of the FAST segment test."""
    return detect_streak(x, 12)


def fast_score_map(img: torch.Tensor, threshold, border: int = 20,
                   streak: int = 9):
    """Dense FAST-16 corner response of one (H, W) level.

    Returns (score, m10, m01): score is 0 for non-corners and otherwise the
    larger of sum(d - t)+ over the ring and sum(-d - t)+, zeroed within
    ``border`` of the edge; m10/m01 are the centroid moments of
    ``patch_moments``.  ``threshold`` may be a float or a 0-d tensor.
    """
    img = img.to(torch.float32)
    t = torch.as_tensor(threshold, dtype=torch.float32, device=img.device)
    h, w = img.shape
    p = edge_pad(img, 3, 3)
    bits_over = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    bits_under = torch.zeros_like(bits_over)
    margin_over = torch.zeros_like(img)
    margin_under = torch.zeros_like(img)
    for i, (dx, dy) in enumerate(RING16):
        d = p[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] - img
        bits_over |= (d > t).to(torch.int32) << i
        bits_under |= (d < -t).to(torch.int32) << i
        margin_over = margin_over + torch.clamp_min(d - t, 0.0)
        margin_under = margin_under + torch.clamp_min(-d - t, 0.0)
    is_corner = (detect_streak(bits_over, streak)
                 | detect_streak(bits_under, streak)) > 0
    score = torch.where(is_corner, torch.maximum(margin_over, margin_under),
                        torch.zeros_like(img))
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = torch.where(inside, score, torch.zeros_like(score))
    m10, m01 = patch_moments(img)
    return score, m10, m01


def _sweep(arr: torch.Tensor, axis: int, n: int, ramp: bool,
           radius: int) -> torch.Tensor:
    """Sum of 2r+1 shifted slices along `axis`, weighted by the offset when
    ``ramp`` (the zero-offset slice is then skipped), added in offset order."""
    out = None
    for i in range(2 * radius + 1):
        coef = float(i - radius)
        if ramp and coef == 0.0:
            continue
        sl = arr.narrow(axis, i, n)
        term = sl * coef if ramp else sl
        out = term if out is None else out + term
    return out


def patch_moments(img: torch.Tensor, radius: int = MOMENT_RADIUS):
    """Dense intensity-centroid moments over a (2r+1)^2 patch, separably:
    m10(x, y) = sum_{|dx|,|dy| <= r} dx * I(x+dx, y+dy); m01 with dy."""
    h, w = img.shape
    p = edge_pad(img, radius, radius)
    box_y = _sweep(p[:, radius: radius + w], 0, h, False, radius)
    box_x = _sweep(p[radius: radius + h, :], 1, w, False, radius)
    m10 = _sweep(edge_pad(box_y, 0, radius), 1, w, True, radius)
    m01 = _sweep(edge_pad(box_x, radius, 0), 0, h, True, radius)
    return m10, m01


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression: keep a pixel iff it is strictly greater than
    its raster-earlier neighbours and >= its later ones (plateaus keep
    exactly one pixel); pixels outside the image count as -inf."""
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    keep = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            if (dy, dx) < (0, 0):
                keep &= score > nb
            else:
                keep &= score >= nb
    return torch.where(keep, score, torch.zeros_like(score))


def fast_maps(img: torch.Tensor, threshold, border: int = 20,
              streak: int = 9, blur_sigma: float = 2.0):
    """Plain version of the fused FAST kernel: returns (score_raw,
    score_nms, m10, m01, blurred), five (H, W) float32 maps."""
    img = img.to(torch.float32)
    score, m10, m01 = fast_score_map(img, threshold, border, streak)
    return score, nms3x3(score), m10, m01, gaussian_blur(img, blur_sigma)
