"""The FAST stage's plain version on every device: this frozen copy runs
no CUDA kernel, so the five maps of each level come from ``fast.fast_maps``
frame by frame and level by level, as the port's wrapper computes them for
CPU tensors."""

from __future__ import annotations

import torch

from slambench.reference.tslam.ops.fast import fast_maps

LAUNCHES = 0


def fast_pyramid_maps(levels, threshold: torch.Tensor, border: int = 20,
                      streak: int = 9, blur_sigma: float = 2.0):
    """(H_l, W_l) or (B, H_l, W_l) float32 levels + a 1-element or (B,)
    float32 threshold -> one (score_raw, score_nms, m10, m01, blurred)
    5-tuple of maps a level."""
    levels = list(levels)
    if levels[0].dim() == 2:
        return [fast_maps(lvl, threshold, border, streak, blur_sigma) for lvl in levels]
    batch = levels[0].shape[0]
    per_frame = threshold.reshape(-1).expand(batch)
    return [tuple(torch.stack(frames) for frames in zip(*(
        fast_maps(im, t, border, streak, blur_sigma) for im, t in zip(lvl, per_frame))))
        for lvl in levels]
