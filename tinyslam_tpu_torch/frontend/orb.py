"""The ORB front-end: frame in, oriented-FAST + binned steered-BRIEF
features out (mirrors ``tinyslam_tpu/frontend/orb.py``).

Per level: the fused FAST kernel (``ops/fast_cuda.py``; its plain version
on CPU tensors) gives the score maps, moments and the blurred level, then
exact top-k compaction and binned BRIEF.  The adaptive threshold stays a
0-d tensor on the image's device, so extraction reads nothing back.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.config import FrontendConfig
from tinyslam_tpu_torch.ops.brief import brief_descriptors_binned
from tinyslam_tpu_torch.ops.compact import select_topk
from tinyslam_tpu_torch.ops.fast_cuda import fast_score_map_fused
from tinyslam_tpu_torch.ops.image import build_pyramid, rgb_to_gray
from tinyslam_tpu_torch.types import Features


def extract_features(image: torch.Tensor, threshold, cfg: FrontendConfig) -> Features:
    """(H, W[, 3]) image -> Features with capacity cfg.max_features.

    ``threshold`` is a float or a 0-d float32 tensor on the image's device.
    """
    if cfg.brief_bins <= 0 or cfg.interpolate_descriptors:
        raise NotImplementedError(
            "continuous-angle BRIEF (brief_bins == 0 or "
            "interpolate_descriptors) is not ported yet; see ROADMAP.md "
            "queue 1, ops/brief.py:brief_descriptors")
    if image.dtype == torch.uint8:
        image = image.to(torch.float32) * (1.0 / 255.0)
    gray = rgb_to_gray(image) if image.dim() == 3 else image.to(torch.float32)
    t = torch.as_tensor(threshold, dtype=torch.float32, device=gray.device).reshape(())

    parts: list[Features] = []
    for lvl, level in enumerate(build_pyramid(gray, cfg.num_levels)):
        score_raw, score_nms, m10, m01, blurred = fast_score_map_fused(
            level, t, cfg.border, cfg.streak_length, cfg.blur_sigma)
        score = score_nms if cfg.nms else score_raw
        sel = select_topk(score, score_raw, m10, m01, cfg.features_per_level)
        desc = brief_descriptors_binned(blurred, sel["xy"], sel["angle"],
                                        sel["valid"], bins=cfg.brief_bins)
        k = cfg.features_per_level
        parts.append(Features(
            xy=sel["xy"] * float(1 << lvl),   # level-0 pixel coords
            level=torch.full((k,), lvl, dtype=torch.int32, device=gray.device),
            angle=sel["angle"],
            score=sel["score"],
            desc=desc,
            valid=sel["valid"],
        ))
    return Features.concatenate(parts)


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
    scalar: ``fe.extract(frame)`` never reads anything back."""

    def __init__(self, cfg: FrontendConfig, device=None):
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
