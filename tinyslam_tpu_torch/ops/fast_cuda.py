"""Fused FAST stage on Hopper: the wrapper of ``csrc/fast.cu``.

Replaces the TPU kernel ``tinyslam_tpu/ops/fast_pallas.py:
fast_score_map_fused``.  ONE launch covers every level of a pyramid, or
of a batch of pyramids (the frame is the grid's second dimension), and
computes, per pixel, the FAST-16 ring bitmasks and the rotate-AND streak
test, the margin score zeroed outside the border, 3x3 NMS, the 15x15
centroid moments and the 7-tap Gaussian blur that BRIEF samples: five
float32 maps from one read of each level.  It is memory-bound on the H100
(a 640x480 frame's four levels read 1.6 MB and write 8.2 MB); the grid is
flat over the 32x32 tiles of all levels, each block stages its tile plus an
8-pixel halo in shared memory once (16-byte ``cp.async`` for rows clear of
the edges) and writes four pixels a thread as ``float4``.  Edges clamp, as
in the plain version ``ops/fast.py:fast_maps``, and every sum runs in the
plain version's order, so the maps agree bit for bit.

A batch of frames shares one threshold or gives each frame its own (B
camera streams, each with its adaptive threshold): the kernel reads frame
b's at ``b * stride`` of the threshold tensor, stride 0 or 1.

CPU tensors take the plain version, frame by frame and level by level;
CUDA tensors launch the kernel or raise.  ``LAUNCHES`` counts kernel
launches: one a pyramid or a batch of pyramids.
"""

from __future__ import annotations

import ctypes

import torch

from tinyslam_tpu_torch.ops import cuda_build
from tinyslam_tpu_torch.ops.fast import fast_maps
from tinyslam_tpu_torch.ops.image import gaussian_kernel

LAUNCHES = 0
MAX_LEVELS = 8          # csrc/fast.cu:MAX_LEVELS


def fast_pyramid_maps(levels, threshold: torch.Tensor, border: int = 20,
                      streak: int = 9, blur_sigma: float = 2.0):
    """A list of (H_l, W_l) float32 levels, or of (B, H_l, W_l) levels of B
    frames, + a float32 threshold on their device -> one (score_raw,
    score_nms, m10, m01, blurred) 5-tuple of float32 maps of the level's
    shape a level, from one kernel launch.

    The threshold is a 1-element tensor shared by every frame, or, for B
    frames, a (B,) tensor: one a frame.  On CUDA the kernel reads it
    through its device pointer, so an adaptive threshold never has to
    visit the host.
    """
    levels = list(levels)
    if not levels:
        raise ValueError("fast_pyramid_maps: no levels")
    dev = levels[0].device
    batched = levels[0].dim() == 3
    lead = levels[0].shape[:1] if batched else ()
    if levels[0].dim() not in (2, 3) or any(
            lvl.dim() != levels[0].dim() or lvl.shape[:-2] != lead for lvl in levels):
        raise ValueError("fast_pyramid_maps: expects (H, W) levels or (B, H, W) levels "
                         "of one B")
    batch = levels[0].shape[0] if batched else 1
    if (not torch.is_tensor(threshold) or threshold.device != dev
            or threshold.dtype != torch.float32 or threshold.numel() not in (1, batch)
            or (threshold.numel() > 1 and threshold.shape != (batch,))):
        raise ValueError("fast_pyramid_maps: threshold must be a 1-element float32 "
                         "tensor, or one (B,) for B frames, on the levels' device")
    if dev.type == "cpu":
        if not batched:
            return [fast_maps(lvl, threshold, border, streak, blur_sigma) for lvl in levels]
        per_frame = threshold.reshape(-1).expand(batch)
        return [tuple(torch.stack(frames) for frames in zip(*(
            fast_maps(im, t, border, streak, blur_sigma) for im, t in zip(lvl, per_frame))))
            for lvl in levels]
    if dev.type != "cuda":
        raise ValueError(f"fast_pyramid_maps: unsupported device {dev}")
    global LAUNCHES
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"fast_pyramid_maps: {len(levels)} levels > {MAX_LEVELS}")
    if any(lvl.device != dev or lvl.dtype != torch.float32 or lvl.numel() == 0
           for lvl in levels):
        raise ValueError("fast_pyramid_maps: expects non-empty float32 levels on "
                         "one device")
    if batch > 65535:
        raise ValueError(f"fast_pyramid_maps: batch {batch} > 65535 (the grid's y)")
    if not 1 <= streak <= 16:
        raise ValueError(f"streak={streak} outside 1..16")
    levels = [lvl.contiguous() for lvl in levels]
    threshold = threshold.contiguous()
    # All maps of all levels in one allocation, map-major: (5, B sum H_l W_l).
    sizes = [lvl.numel() for lvl in levels]
    buf = torch.empty((5, sum(sizes)), dtype=torch.float32, device=dev)
    out, ptrs, dims, off = [], [], [], 0
    for lvl, size in zip(levels, sizes):
        maps = tuple(buf[k, off:off + size].view(lvl.shape) for k in range(5))
        out.append(maps)
        ptrs += [lvl.data_ptr()] + [m.data_ptr() for m in maps]
        dims += list(lvl.shape[-2:])
        off += size
    taps = [float(v) for v in gaussian_kernel(blur_sigma)]
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        err = lib.tinyslam_fast_pyramid(
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(dims))(*dims),
            len(levels), batch, threshold.data_ptr(), int(threshold.numel() > 1), border,
            streak,
            (ctypes.c_float * len(taps))(*taps), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "tinyslam_fast_pyramid")
    LAUNCHES += 1
    return out


def fast_score_map_fused(img: torch.Tensor, threshold: torch.Tensor,
                         border: int = 20, streak: int = 9,
                         blur_sigma: float = 2.0):
    """(H, W) float32 level + 0-d float32 threshold on the same device ->
    (score_raw, score_nms, m10, m01, blurred), five (H, W) float32 maps: the
    pyramid kernel on a pyramid of one level."""
    if img.dim() != 2:
        raise ValueError("fast_score_map_fused: expects an (H, W) map")
    return fast_pyramid_maps([img], threshold, border, streak, blur_sigma)[0]
