"""Image ops: grayscale, pyramid downsample, separable Gaussian blur
(mirrors ``tinyslam_tpu/ops/image.py``).

The blur is a sum of shifted slices of an edge-padded copy, tap by tap in
the JAX package's order, so that the CUDA FAST kernel (which computes the
same blur) can round exactly as this plain version does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slambench.reference.tslam.ops.fmath import fma

# Rec.601 luminance coefficients.
LUMA = (0.299, 0.587, 0.114)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3|4) RGB[A] -> (..., H, W) float32 luminance in [0, 1].

    The JAX package's CPU backend computes the three-term dot as
    fma(b, w2, fma(g, w1, r w0)); so does this, on any device.  uint8 is
    divided by 255 with a divisor tensor on the device: divided by a
    Python number, a CUDA tensor is multiplied by its reciprocal, which
    rounds differently from a true division.
    """
    if rgb.dtype == torch.uint8:
        rgb = rgb.to(torch.float32) / torch.full((), 255.0, device=rgb.device)
    rgb = rgb.to(torch.float32)
    w = [float(np.float32(v)) for v in LUMA]
    return fma(rgb[..., 2], w[2], fma(rgb[..., 1], w[1], rgb[..., 0] * w[0]))


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H//2, W//2) by 2x2 average.  The four pixels are
    added in raster order, the order in which the JAX package's mean
    reduces them on the CPU, so the levels agree bit for bit."""
    *b, h, w = img.shape
    h2, w2 = h // 2, w // 2
    x = img[..., : h2 * 2, : w2 * 2].reshape(*b, h2, 2, w2, 2)
    s = x[..., 0, :, 0] + x[..., 0, :, 1] + x[..., 1, :, 0] + x[..., 1, :, 1]
    return s * 0.25


def gaussian_kernel(sigma: float, radius: int = 3) -> np.ndarray:
    """Normalized 1D Gaussian taps of width 2*radius+1 (float32)."""
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def edge_pad(img: torch.Tensor, pad_y: int, pad_x: int) -> torch.Tensor:
    """Replicate-pad the last two axes of an (H, W) map."""
    return F.pad(img[None, None], (pad_x, pad_x, pad_y, pad_y),
                 mode="replicate")[0, 0]


def _conv1d_axis(img: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Edge-padded 1D convolution along `axis` (0 = rows, 1 = columns) of an
    (H, W) map: ``out = sum_k slice_k * taps[k]``, added in tap order."""
    r = (len(taps) - 1) // 2
    p = edge_pad(img, r, 0) if axis == 0 else edge_pad(img, 0, r)
    n = img.shape[axis]
    out = None
    for i, t in enumerate(taps):
        term = p.narrow(axis, i, n) * float(t)
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) map: X pass, then Y pass."""
    taps = gaussian_kernel(sigma, radius)
    return _conv1d_axis(_conv1d_axis(img, taps, axis=1), taps, axis=0)


def build_pyramid(gray: torch.Tensor, num_levels: int) -> list[torch.Tensor]:
    """Level n has shape (H/2^n, W/2^n)."""
    levels = [gray]
    for _ in range(1, num_levels):
        levels.append(downsample2x(levels[-1]))
    return levels
