"""Frozen configuration tree, mirrored field for field from
``tinyslam_tpu/config.py`` so that one config drives both packages and
``SlamConfig().to_json()`` is identical in both.  The rationale for each
default lives beside the field in the JAX package."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def _fromdict(cls: type, d: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = _TYPES.get(f.type, f.type) if isinstance(f.type, str) else f.type
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _fromdict(ftype, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


class _JsonMixin:
    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str):
        return _fromdict(cls, json.loads(s))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FrontendConfig(_JsonMixin):
    """ORB front-end: image size, pyramid, FAST and BRIEF settings."""

    height: int = 480
    width: int = 640
    num_levels: int = 4
    threshold: float = 0.06        # FAST threshold on [0, 1] intensities
    features_per_level: int = 512  # static top-k capacity per pyramid level
    streak_length: int = 9         # FAST-N contiguous-arc length
    border: int = 20               # >= ceil(13*sqrt(2)): rotated BRIEF reach
    blur_sigma: float = 2.0        # 7-tap Gaussian that BRIEF samples
    nms: bool = True               # 3x3 non-max suppression
    use_pallas: bool = True        # JAX package only: Pallas kernel on a TPU
    interpolate_descriptors: bool = False
    brief_bins: int = 16           # orientation bins of the binned BRIEF
    adaptive_threshold: bool = True
    target_fill: float = 0.75      # desired detected/capacity ratio

    @property
    def max_features(self) -> int:
        return self.features_per_level * self.num_levels


@dataclass(frozen=True)
class MatcherConfig(_JsonMixin):
    """Hamming descriptor matcher."""

    max_distance: int = 64
    ratio: float = 0.9
    cross_check: bool = True


@dataclass(frozen=True)
class RansacConfig(_JsonMixin):
    """Batched-hypothesis RANSAC for two-view geometry."""

    num_hypotheses: int = 512
    sample_size: int = 5
    inlier_threshold: float = 2e-3
    refine_iters: int = 3


@dataclass(frozen=True)
class BAConfig(_JsonMixin):
    """Schur-complement Levenberg-Marquardt local bundle adjustment."""

    max_keyframes: int = 10
    max_landmarks: int = 2048
    max_iters: int = 6
    damping_init: float = 1e-3
    damping_up: float = 10.0
    damping_down: float = 0.5
    huber_delta: float = 5.0
    cg_iters: int = 0


@dataclass(frozen=True)
class VOConfig(_JsonMixin):
    """Frame-to-frame visual odometry loop."""

    max_map_points: int = 8192
    pnp_iters: int = 8
    track_radius_px: float = 20.0
    pnp_inlier_px: float = 4.0
    keyframe_min_inliers: int = 150
    keyframe_max_interval: int = 20
    keyframe_min_interval: int = 3
    keyframe_critical_inliers: int = 30
    reloc_hypotheses: int = 512
    staged_reloc: bool = True
    dup_radius_px: float = 48.0
    tri_local_band: float = 1.8
    reloc_max_frames: int = 8
    track_two_pass: bool = True
    second_pass_below: int = 150
    min_parallax_deg: float = 1.5
    tri_band_lo: float = 0.25
    tri_band_hi: float = 4.0


@dataclass(frozen=True)
class PoseGraphConfig(_JsonMixin):
    """Pose-graph optimization (loop closure back-end)."""

    max_nodes: int = 256
    max_edges: int = 1024
    gn_iters: int = 20
    loop_candidates: int = 2
    loop_cooldown: int = 5
    loop_min_matches: int = 40
    loop_min_gap: int = 30
    loop_min_inlier_ratio: float = 0.4
    loop_max_rmse_px: float = 4.0
    loop_min_scale_pairs: int = 12
    sim3: bool = True


@dataclass(frozen=True)
class MeshConfig(_JsonMixin):
    """Device-mesh layout of the JAX package (kept for config parity)."""

    frame_axis: int = 1
    landmark_axis: int = 1


@dataclass(frozen=True)
class SlamConfig(_JsonMixin):
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    vo: VOConfig = field(default_factory=VOConfig)
    pose_graph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# `from __future__ import annotations` turns field types into strings;
# resolve the nested config classes by name for from_json.
_TYPES = {c.__name__: c for c in (
    FrontendConfig, MatcherConfig, RansacConfig, BAConfig, VOConfig,
    PoseGraphConfig, MeshConfig)}


def slice_config(base: SlamConfig | None = None) -> SlamConfig:
    """``base`` (default: full-width ``SlamConfig()``) with keyframe
    insertion switched off through existing VOConfig fields, so that
    ``need_kf`` is always false: the tracked-frame slice this package
    ports."""
    base = base or SlamConfig()
    return base.replace(vo=base.vo.replace(
        keyframe_min_inliers=0, keyframe_critical_inliers=0,
        keyframe_max_interval=2**30))
