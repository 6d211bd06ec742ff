"""Fused FAST stage on Hopper: the wrapper of ``csrc/fast.cu``.

Replaces the TPU kernel ``tinyslam_tpu/ops/fast_pallas.py:
fast_score_map_fused``.  One launch per pyramid level computes, per pixel,
the FAST-16 ring bitmasks and the rotate-AND streak test, the margin score
zeroed outside the border, 3x3 NMS, the 15x15 centroid moments and the
7-tap Gaussian blur that BRIEF samples: five float32 maps from one read of
the level.  It is memory-bound on the H100 (at 640x480 it reads one map and
writes five, about 7.4 MB); each block stages its 32x32 tile plus an
8-pixel halo in shared memory once and computes every stencil from there.
Edges clamp, as in the plain version ``ops/fast.py:fast_maps``, and every
sum runs in the plain version's order, so the maps agree bit for bit.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.ops import cuda_build
from tinyslam_tpu_torch.ops.fast import fast_maps
from tinyslam_tpu_torch.ops.image import gaussian_kernel

LAUNCHES = 0


def fast_score_map_fused(img: torch.Tensor, threshold: torch.Tensor,
                         border: int = 20, streak: int = 9,
                         blur_sigma: float = 2.0):
    """(H, W) float32 level + 0-d float32 threshold on the same device ->
    (score_raw, score_nms, m10, m01, blurred), five (H, W) float32 maps.

    On CUDA the threshold is read by the kernel through its device pointer,
    so an adaptive threshold never has to visit the host.
    """
    if img.device.type == "cpu":
        return fast_maps(img, threshold, border, streak, blur_sigma)
    if img.device.type != "cuda":
        raise ValueError(f"fast_score_map_fused: unsupported device {img.device}")
    global LAUNCHES
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError("fast_score_map_fused: expects an (H, W) float32 map")
    if not 1 <= streak <= 16:
        raise ValueError(f"streak={streak} outside 1..16")
    if (not torch.is_tensor(threshold) or threshold.device != img.device
            or threshold.dtype != torch.float32 or threshold.numel() != 1):
        raise ValueError("fast_score_map_fused: threshold must be a 1-element "
                         "float32 tensor on the image's device")
    img = img.contiguous()
    threshold = threshold.contiguous()
    h, w = img.shape
    outs = [torch.empty_like(img) for _ in range(5)]
    taps = [float(v) for v in gaussian_kernel(blur_sigma)]
    lib = cuda_build.load_library()
    with torch.cuda.device(img.device):
        err = lib.tinyslam_fast_maps(
            img.data_ptr(), threshold.data_ptr(), *(o.data_ptr() for o in outs),
            h, w, border, streak, *taps, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "tinyslam_fast_maps")
    LAUNCHES += 1
    return tuple(outs)
