"""Brute-force Hamming matching (mirrors the XLA branch of
``tinyslam_tpu/ops/hamming.py``).

``match_reduce_plain`` is the plain version of the streaming CUDA matcher
in ``ops/match_cuda.py``: it materializes the (N, M) distance matrix,
replaces invalid pairs and pairs outside the guided gate by ``BIG``, and
reduces it to per-row best / argmin / second-best and per-column argmin.
Ties go to the lowest index on both sides.  ``match_descriptors`` adds the
distance bound, ratio test and cross-check on top.  Every input may carry
a leading sequence dimension B: B independent matchings, each with its own
gate, as the JAX package's ``vmap`` over camera streams gives them.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyslam_tpu_torch.types import descriptor_signs
from tinyslam_tpu_torch.utils.cuda_graph import device_span

BIG = 1 << 14  # distance of an invalid or gated-out pair (> 256)


def hamming_distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) x (..., M, 8) packed int32 -> (..., N, M) int32 Hamming
    distances.

    hamming = (256 - signs(a) . signs(b)) / 2.  torch has no integer matmul
    on CUDA, so the dot runs in float32; sums of 256 values of +-1 are
    exact there (TF32 is off, see the package ``__init__``).
    """
    sa = descriptor_signs(desc_a).to(torch.float32)
    sb = descriptor_signs(desc_b).to(torch.float32)
    dot = sa @ sb.transpose(-1, -2)
    return ((256.0 - dot) * 0.5).to(torch.int32)


def gate_radius2(radius_px: float) -> float:
    """r^2 rounded to float32 once, as the JAX package compares it."""
    return float(np.float32(radius_px * radius_px))


def match_reduce_plain(desc_a, valid_a, desc_b, valid_b, xy_a=None,
                       proj_b=None, radius_px: float = 0.0, pair_mask=None):
    """Plain version of the streaming matcher.

    Returns (best, second, idx_b, col_idx), all int32: per row the smallest
    distance, the next smallest excluding exactly the argmin column, and the
    argmin; per column the argmin over rows.  ``pair_mask`` (N, M), when
    given, replaces the guided gate of ``xy_a``/``proj_b``/``radius_px``.
    With a leading B on the inputs, the outputs are (B, N) and (B, M).
    """
    big = torch.full((), BIG, dtype=torch.int32, device=desc_a.device)
    d = hamming_distance_matrix(desc_a, desc_b)
    d = torch.where(valid_a[..., :, None] & valid_b[..., None, :], d, big)
    if pair_mask is None and xy_a is not None and proj_b is not None:
        du = xy_a[..., :, None, 0] - proj_b[..., None, :, 0]
        dv = xy_a[..., :, None, 1] - proj_b[..., None, :, 1]
        pair_mask = du * du + dv * dv < gate_radius2(radius_px)
    if pair_mask is not None:
        d = torch.where(pair_mask, d, big)
    idx_b = torch.argmin(d, dim=-1)
    best = d.gather(-1, idx_b[..., None])[..., 0]
    second = d.scatter(-1, idx_b[..., None], BIG).min(dim=-1).values
    col_idx = torch.argmin(d, dim=-2)
    return best, second, idx_b.to(torch.int32), col_idx.to(torch.int32)


def match_descriptors(desc_a, valid_a, desc_b, valid_b, max_distance: int = 64,
                      ratio: float = 0.9, cross_check: bool = True,
                      pair_mask=None, xy_a=None, proj_b=None,
                      radius_px: float = 0.0, span: str | None = None) -> dict:
    """Mutual-nearest Hamming matching with Lowe ratio test.

    Guided matching (map points eligible only near their predicted
    projection) is either ``pair_mask`` (N, M) bool or ``xy_a`` (N, 2) +
    ``proj_b`` (M, 2) + ``radius_px``, computed on the fly (park ineligible
    B entries at a far-away projection).  On CUDA tensors the reduction is
    the streaming kernel; on CPU tensors its plain version.  A leading B on
    every input matches B independent pairs of sets, each gated by its own
    xy_a and proj_b or its own mask, in one launch.

    Returns dict with idx_b (N,) int32, dist (N,) int32 and valid (N,) bool
    (distance bound, ratio test and cross-check passed), (B, N) with a B.
    ``span`` names the reduction's span in a captured step
    (``utils/cuda_graph.py:device_span``).
    """
    from tinyslam_tpu_torch.ops.match_cuda import match_reduce

    n = desc_a.shape[-2]
    with device_span(span):
        best, second, idx_b, col_idx = match_reduce(
            desc_a, valid_a, desc_b, valid_b, xy_a=xy_a, proj_b=proj_b,
            radius_px=radius_px, pair_mask=pair_mask)
    ok = best <= max_distance
    ok &= best.to(torch.float32) <= ratio * second.to(torch.float32)
    if cross_check:
        ok &= col_idx.gather(-1, idx_b.long()) == torch.arange(
            n, dtype=torch.int32, device=desc_a.device)
    ok &= valid_a
    return {"idx_b": idx_b, "dist": best, "valid": ok}
