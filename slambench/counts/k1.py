"""The least time of K1, the fused FAST stage (``fast_pyramid_maps``), for
the work its inputs need: each pyramid level read once as float32 and its
five float32 maps written once, plus each threshold read, against the
card's memory rate; or its float operations against float32's peak,
whichever is longer.  The count is ``chip_smoke.py`` phase 7's."""

# Float operations a pixel: the ring 16 x (1 sub, 2 compares, 2 subs,
# 2 max, 2 adds) + 1 max, box sums 2 x 14 adds, ramps 2 x (14 mul + 13
# add), blur 2 x (7 mul + 6 add), NMS 8 compares.
FLOPS_PER_PIXEL = 16 * 9 + 1 + 28 + 54 + 26 + 8


def work(level_shapes, frames: int = 1, thresholds: int = 1) -> tuple[float, float]:
    """(bytes, float operations) of one launch over ``frames`` frames whose
    pyramid levels have the (H, W) ``level_shapes``, reading
    ``thresholds`` float32 thresholds."""
    pixels = frames * sum(h * w for h, w in level_shapes)
    return 4 * pixels * 6 + 4 * thresholds, FLOPS_PER_PIXEL * pixels


def least_s(level_shapes, peaks: dict, frames: int = 1, thresholds: int = 1) -> float:
    nbytes, flops = work(level_shapes, frames, thresholds)
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["fp32_flops_per_s"])
