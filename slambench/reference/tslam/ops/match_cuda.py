"""The streaming matcher's plain version on every device: this frozen
copy runs no CUDA kernel, so every reduction is ``hamming.match_reduce_plain``."""

from __future__ import annotations

from slambench.reference.tslam.ops.hamming import match_reduce_plain

LAUNCHES = 0


def match_reduce(desc_a, valid_a, desc_b, valid_b, xy_a=None, proj_b=None,
                 radius_px: float = 0.0, pair_mask=None):
    return match_reduce_plain(desc_a, valid_a, desc_b, valid_b, xy_a=xy_a, proj_b=proj_b,
                              radius_px=radius_px, pair_mask=pair_mask)
