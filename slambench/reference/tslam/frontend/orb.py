"""The ORB front-end: frame in, oriented-FAST + steered-BRIEF features
out (mirrors ``tinyslam_tpu/frontend/orb.py``).

One launch of the fused FAST kernel over the whole pyramid
(``ops/fast_cuda.py:fast_pyramid_maps``; its plain version on CPU tensors),
or over the pyramids of a batch of frames (``extract_batch``, with one
threshold or one a frame), gives every level's score maps, moments and
blurred level; then, per level and under the profiler label
``orb_level{n}``, exact top-k compaction and BRIEF over the whole batch at
once: binned (``brief_bins`` > 0), or with the continuous angle, nearest or
bilinear (``brief_bins`` 0 or ``interpolate_descriptors``).  The adaptive
threshold stays a tensor on the image's device, so extraction reads
nothing back.
"""

from __future__ import annotations

import torch

from slambench.reference.tslam.config import FrontendConfig
from slambench.reference.tslam.ops.brief import brief_descriptors, brief_descriptors_binned
from slambench.reference.tslam.ops.compact import select_topk
from slambench.reference.tslam.ops.fast_cuda import fast_pyramid_maps
from slambench.reference.tslam.ops.image import build_pyramid, rgb_to_gray
from slambench.reference.tslam.types import Features
from slambench.reference.tslam.utils.profiling import named_scope


def _gray(image: torch.Tensor, rgb: bool) -> torch.Tensor:
    """Float32 luminance of an image or a batch: uint8 scaled to [0, 1]."""
    if image.dtype == torch.uint8:
        image = image.to(torch.float32) * (1.0 / 255.0)
    return rgb_to_gray(image) if rgb else image.to(torch.float32)


def _features(maps, cfg: FrontendConfig, device) -> Features:
    """Features from the levels' five K1 maps, (H_l, W_l) for one frame or
    (B, H_l, W_l) for B: exact top-k and BRIEF a level, over the batch."""
    parts: list[Features] = []
    k = cfg.features_per_level
    lead = maps[0][0].shape[:-2]
    for lvl, (score_raw, score_nms, m10, m01, blurred) in enumerate(maps):
        with named_scope(f"orb_level{lvl}"):
            score = score_nms if cfg.nms else score_raw
            sel = select_topk(score, score_raw, m10, m01, k)
            if cfg.brief_bins > 0 and not cfg.interpolate_descriptors:
                desc = brief_descriptors_binned(blurred, sel["xy"], sel["angle"],
                                                sel["valid"], bins=cfg.brief_bins)
            else:
                desc = brief_descriptors(blurred, sel["xy"], sel["angle"], sel["valid"],
                                         interpolate=cfg.interpolate_descriptors)
            parts.append(Features(
                xy=sel["xy"] * float(1 << lvl),   # level-0 pixel coords
                level=torch.full((*lead, k), lvl, dtype=torch.int32, device=device),
                angle=sel["angle"],
                score=sel["score"],
                desc=desc,
                valid=sel["valid"],
            ))
    return Features.concatenate(parts, dim=len(lead))


def extract_features(image: torch.Tensor, threshold, cfg: FrontendConfig) -> Features:
    """(H, W[, 3]) image -> Features with capacity cfg.max_features.

    ``threshold`` is a float or a 0-d float32 tensor on the image's device.
    """
    gray = _gray(image, image.dim() == 3)
    t = torch.as_tensor(threshold, dtype=torch.float32, device=gray.device).reshape(())
    maps = fast_pyramid_maps(build_pyramid(gray, cfg.num_levels), t, cfg.border,
                             cfg.streak_length, cfg.blur_sigma)
    return _features(maps, cfg, gray.device)


def extract_batch(images: torch.Tensor, threshold, cfg: FrontendConfig) -> Features:
    """(B, H, W[, 3]) frames -> Features with a leading B, each frame's equal
    to ``extract_features`` of that frame at its threshold (the counterpart
    of the JAX package's vmapped ``parallel/frontend_dp.py:_extract_batch``
    and of the front-end of its vmapped ``track_chunk``).

    ``threshold`` is one for all frames (a float or a 0-d float32 tensor on
    the frames' device) or one a frame (a (B,) float32 tensor: B camera
    streams, each with its adaptive threshold).  The grayscale and the
    pyramid run over the whole batch, K1 once for all B frames and their
    levels, top-k and BRIEF a level over all B frames at once.
    """
    gray = _gray(images, images.dim() == 4)
    t = torch.as_tensor(threshold, dtype=torch.float32, device=gray.device)
    if t.dim() > 0 and t.shape != gray.shape[:1]:
        raise ValueError(f"extract_batch: {tuple(t.shape)} thresholds for "
                         f"{gray.shape[0]} frames")
    maps = fast_pyramid_maps(build_pyramid(gray, cfg.num_levels), t.reshape(t.shape or (1,)),
                             cfg.border, cfg.streak_length, cfg.blur_sigma)
    return _features(maps, cfg, gray.device)


def adapt_threshold(threshold: torch.Tensor, count: torch.Tensor,
                    capacity: int, target: float) -> torch.Tensor:
    """Multiplicative FAST-threshold controller, on the device: nudge the
    threshold so the detected/capacity fill ratio tracks ``target``."""
    fill = count.to(torch.float32) / capacity
    th = torch.where(fill > min(0.99, target * 1.2),
                     torch.clamp_max(threshold * 1.1, 0.5), threshold)
    return torch.where(fill < target * 0.8, torch.clamp_min(th * 0.9, 0.01), th)


class OrbFrontend:
    """Config-bound front-end holding the adaptive threshold as a device
    scalar: ``fe.extract(frame)`` never reads anything back.  ``device`` is
    required: the threshold lives there (``"cpu"`` for the plain path)."""

    def __init__(self, cfg: FrontendConfig, *, device):
        self.cfg = cfg
        self._threshold = torch.tensor(cfg.threshold, dtype=torch.float32,
                                       device=device)

    @property
    def threshold(self) -> float:
        """Current FAST threshold (reads the device)."""
        return float(self._threshold)

    @threshold.setter
    def threshold(self, value: float) -> None:
        self._threshold = torch.tensor(value, dtype=torch.float32,
                                       device=self._threshold.device)

    def extract(self, image: torch.Tensor, threshold: float | None = None) -> Features:
        if threshold is not None:
            return extract_features(image, threshold, self.cfg)
        feats = extract_features(image, self._threshold.to(image.device), self.cfg)
        if self.cfg.adaptive_threshold:
            self._threshold = adapt_threshold(
                self._threshold.to(image.device), feats.count,
                self.cfg.max_features, self.cfg.target_fill)
        return feats
