"""Steered BRIEF-256, with continuous or binned orientation (mirrors
``tinyslam_tpu/ops/brief.py``: ``brief_descriptors`` and
``brief_descriptors_binned``).

Continuous: the pattern is rotated by each feature's angle and sampled at
the nearest pixel or bilinearly.  Its arithmetic follows the JAX package's
on the CPU bit for bit: sine and cosine round as the C library's
(``ops/fmath.py``), and the products that XLA contracts into fused
multiply-adds are fused here too (``fmath.fma``), in the same pairs.

Binned: the JAX package forms every bin's 256 differences with one
``(N, 1600) x (1600, bins*256)`` matmul against a +-1 table: each output is
exactly ``va - vb`` of one pattern pair.  Here the same two pixels are
gathered directly and subtracted, which rounds identically (one f32
subtraction) and does no matmul, so the bits are the same.  The table
itself (``_binned_tables``) is kept as the definition the offsets are
checked against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from slambench.reference.tslam.ops.fmath import fma, sincosf
from slambench.reference.tslam.types import pack_descriptor_bits

PATCH_RADIUS = 13  # +/-13 box of the sampling pattern


def _make_pattern(num_pairs: int = 256, seed: int = 7) -> np.ndarray:
    """(num_pairs, 2, 2) int32: [pair, point a/b, (x, y)]; deterministic
    Gaussian pairs, clipped to the box, with degenerate pairs redrawn."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(num_pairs, 2, 2))
    pts = np.clip(np.rint(pts), -PATCH_RADIUS, PATCH_RADIUS).astype(np.int32)
    for i in range(num_pairs):
        while (pts[i, 0] == pts[i, 1]).all():
            pts[i, 1] = np.clip(
                np.rint(rng.normal(0.0, sigma, size=2)), -PATCH_RADIUS, PATCH_RADIUS
            ).astype(np.int32)
    return pts


BRIEF_PATTERN: np.ndarray = _make_pattern()

# Rotated-pattern reach: |R(theta) p|_inf <= |p|_2 <= 13*sqrt(2) < 19.
PATCH_REACH = 19
PATCH_SIDE = 2 * PATCH_REACH + 2   # 40


@functools.lru_cache(maxsize=4)
def _binned_offsets(bins: int) -> np.ndarray:
    """(bins, 256, 2, 2) int64: pattern point k of pair j rotated by the bin
    angle 2*pi*a/bins and rounded, as (ox, oy) offsets from the centre."""
    pat = BRIEF_PATTERN.astype(np.float64)
    out = np.zeros((bins, 256, 2, 2), np.int64)
    for a in range(bins):
        th = 2.0 * np.pi * a / bins
        c, s = np.cos(th), np.sin(th)
        for j in range(256):
            for k in range(2):
                px, py = pat[j, k]
                out[a, j, k] = (int(np.rint(c * px - s * py)),
                                int(np.rint(s * px + c * py)))
    return out


@functools.lru_cache(maxsize=4)
def _binned_tables(bins: int) -> np.ndarray:
    """(PATCH_SIDE^2, bins*256) float32 difference-selection matrix of the
    JAX package: column a*256+j has +1 at point a's in-patch offset and -1
    at point b's (they cancel when both round onto one cell)."""
    ps = PATCH_SIDE
    off = _binned_offsets(bins)
    D = np.zeros((ps * ps, bins * 256), np.float32)
    for a in range(bins):
        for j in range(256):
            for k, sign in ((0, 1.0), (1, -1.0)):
                ox, oy = off[a, j, k]
                D[(oy + PATCH_REACH) * ps + (ox + PATCH_REACH), a * 256 + j] += sign
    return D


@functools.lru_cache(maxsize=8)
def _pattern_on(device: torch.device) -> torch.Tensor:
    """``BRIEF_PATTERN`` as float32 on ``device``, uploaded once."""
    return torch.from_numpy(BRIEF_PATTERN.astype(np.float32)).to(device)


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat[idx]`` for a flat image (P,), or per image of a (..., P)
    batch with idx (..., *rest) indexing its own image.  A negative index
    counts from the end, as in ``flat[idx]`` (and the JAX package's
    indexing): a level lower than the binned patch clamps its origin
    below 0."""
    lead = flat.shape[:-1]
    idx = torch.remainder(idx, flat.shape[-1])
    return flat.gather(-1, idx.reshape(*lead, -1)).reshape(idx.shape)


def brief_samples(blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor,
                  interpolate: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The two intensities (..., N, 256) that each bit of
    ``brief_descriptors`` compares: the pattern's points a and b rotated by
    each feature's angle about its position, sampled from ``blurred``
    (..., H, W), a leading batch dimension per image."""
    h, w = blurred.shape[-2:]
    flat = blurred.reshape(*blurred.shape[:-2], -1)
    pat = _pattern_on(blurred.device)
    s, c = sincosf(angle)
    s, c = s[..., None], c[..., None]
    x0, y0 = xy[..., 0:1], xy[..., 1:2]

    def rotated(px, py):
        # XLA's contraction: rx = fma(c, px, -(s py)) + x0,
        # ry = fma(s, px, c py) + y0.
        return fma(c, px, -(s * py)) + x0, fma(s, px, c * py) + y0

    def sample(rx, ry):
        if interpolate:
            fx = torch.clamp(rx, 0.0, float(np.float32(w - 1.001)))
            fy = torch.clamp(ry, 0.0, float(np.float32(h - 1.001)))
            x1 = torch.floor(fx).to(torch.int64)
            y1 = torch.floor(fy).to(torch.int64)
            ax = fx - x1.to(torch.float32)
            ay = fy - y1.to(torch.float32)
            i00 = _take(flat, y1 * w + x1)
            i01 = _take(flat, y1 * w + x1 + 1)
            i10 = _take(flat, (y1 + 1) * w + x1)
            i11 = _take(flat, (y1 + 1) * w + x1 + 1)
            # (i00 (1 - ax) + i01 ax) (1 - ay) + (i10 (1 - ax) + i11 ax) ay,
            # fused as XLA fuses it.
            top = fma(i01, ax, i00 * (1.0 - ax))
            bottom = fma(i11, ax, i10 * (1.0 - ax))
            return fma(top, 1.0 - ay, bottom * ay)
        tx = torch.clamp(torch.round(rx).to(torch.int64), 0, w - 1)
        ty = torch.clamp(torch.round(ry).to(torch.int64), 0, h - 1)
        return _take(flat, ty * w + tx)

    va = sample(*rotated(pat[None, :, 0, 0], pat[None, :, 0, 1]))
    vb = sample(*rotated(pat[None, :, 1, 0], pat[None, :, 1, 1]))
    return va, vb


def brief_descriptors(blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor,
                      valid: torch.Tensor, interpolate: bool = False) -> torch.Tensor:
    """Steered BRIEF-256 for the features of ONE blurred pyramid level (or
    of one level of each image of a batch: every argument then carries the
    same leading dimensions), with the pattern rotated by each feature's
    continuous angle.

    blurred (H, W) float32; xy (N, 2) positions in this level's pixels;
    angle (N,) radians; valid (N,).  Nearest sampling rounds half to even
    and clamps into the image; ``interpolate`` samples bilinearly, clamped
    to [0, W - 1.001] x [0, H - 1.001].  Returns (N, 8) int32 packed
    descriptors, zero for invalid slots.
    """
    va, vb = brief_samples(blurred, xy, angle, interpolate)
    desc = pack_descriptor_bits(va > vb)
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))


@functools.lru_cache(maxsize=8)
def _offsets_on(bins: int, device: torch.device) -> torch.Tensor:
    """``_binned_offsets`` uploaded to ``device`` once: a copy from host
    memory on every call would synchronize the host with the device."""
    return torch.from_numpy(_binned_offsets(bins)).to(device)


def brief_descriptors_binned(blurred: torch.Tensor, xy: torch.Tensor,
                             angle: torch.Tensor, valid: torch.Tensor,
                             bins: int = 32) -> torch.Tensor:
    """Steered BRIEF-256 with orientation quantized to ``bins``.

    blurred (H, W) is the blurred level; xy (N, 2) feature positions in this
    level's pixels; angle (N,) radians; valid (N,).  The 40x40 patch origin
    is clamped into the image, as in the JAX package.  Returns (N, 8) int32
    packed descriptors, zero for invalid slots.  A leading batch dimension
    on every argument describes one level of each image of a batch.
    """
    h, w = blurred.shape[-2:]
    dev = blurred.device
    ps = PATCH_SIDE
    center = torch.round(xy).to(torch.int64)
    bx = torch.clamp(center[..., 0] - PATCH_REACH, 0, w - ps)
    by = torch.clamp(center[..., 1] - PATCH_REACH, 0, h - ps)

    bin_idx = torch.remainder(
        torch.round(angle / (2.0 * np.pi / bins)).to(torch.int64), bins)
    off = _offsets_on(bins, dev)[bin_idx]                             # (..., N,256,2,2)
    px = bx[..., None, None] + PATCH_REACH + off[..., 0]
    py = by[..., None, None] + PATCH_REACH + off[..., 1]
    v = _take(blurred.reshape(*blurred.shape[:-2], -1), py * w + px)  # (..., N,256,2)
    bits = (v[..., 0] - v[..., 1]) > 0
    desc = pack_descriptor_bits(bits)
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))
