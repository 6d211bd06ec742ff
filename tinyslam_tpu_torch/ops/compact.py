"""Deterministic feature compaction: dense score map -> fixed-capacity list
(mirrors the exact top-k path of ``tinyslam_tpu/ops/compact.py``).

Ties go to the lowest flat index, as ``lax.top_k`` does: a stable
descending sort gives that order, where ``torch.topk`` promises none.
"""

from __future__ import annotations

import torch


def _subpixel_offset(flat: torch.Tensor, idx: torch.Tensor, stride: int,
                     n: int) -> torch.Tensor:
    """1D quadratic-fit offset along a flat-index stride, clipped to +-0.5."""
    s0 = flat[idx]
    sl = flat[torch.clamp(idx - stride, 0, n - 1)]
    sr = flat[torch.clamp(idx + stride, 0, n - 1)]
    denom = sl - 2.0 * s0 + sr
    safe = torch.where(denom.abs() > 1e-9, denom, torch.full_like(denom, 1e9))
    return torch.clamp(0.5 * (sl - sr) / safe, -0.5, 0.5)


def select_topk(score_sel: torch.Tensor, score_raw: torch.Tensor,
                m10: torch.Tensor, m01: torch.Tensor, k: int) -> dict:
    """Select the k highest-scoring pixels of one (H, W) level.

    Returns xy (k, 2) sub-pixel (x, y) in this level's pixels, angle (k,)
    atan2(m01, m10), score (k,) and valid (k,) = score > 0; invalid slots
    are zero.
    """
    h, w = score_sel.shape
    flat_sel = score_sel.reshape(-1)
    flat_raw = score_raw.reshape(-1)
    n = flat_sel.shape[0]
    vals, idx = torch.sort(flat_sel, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    y = idx // w
    x = idx % w
    valid = vals > 0.0
    dx = _subpixel_offset(flat_raw, idx, 1, n)
    dy = _subpixel_offset(flat_raw, idx, w, n)
    ang = torch.atan2(m01.reshape(-1)[idx], m10.reshape(-1)[idx])
    xy = torch.stack([x.to(torch.float32) + dx, y.to(torch.float32) + dy], dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=xy.device)
    return {
        "xy": torch.where(valid[:, None], xy, zero),
        "angle": torch.where(valid, ang, zero),
        "score": torch.where(valid, vals, zero),
        "valid": valid,
    }
