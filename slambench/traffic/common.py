"""What the traffic drivers share: the port's camera of a configuration and
a tracker state seeded from the generator's ground truth."""

from __future__ import annotations

import torch


def camera(config: dict):
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera

    c = config["camera"]
    return PinholeCamera.create(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"])


def seeded_state(cfg, config: dict, lap: dict, frame: int):
    """A tracker state at lap frame ``frame``'s pose whose map holds that
    frame's features at their ray-cast ground-truth points
    (``VOState.seeded``: a tracking state without the two-view
    bootstrap)."""
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.models.vo_device import VOState

    feats = extract_features(lap["frames"][frame], cfg.frontend.threshold, cfg.frontend)
    R, t = torch.from_numpy(lap["R"][frame]), torch.from_numpy(lap["t"][frame])
    X = lap["room"].points(config["camera"], R, t, feats.xy[feats.valid])
    return VOState.seeded(cfg, feats, X, R, t)
