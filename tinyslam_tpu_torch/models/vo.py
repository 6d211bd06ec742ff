"""Landmark map and the tracking helpers of the visual odometry (mirrors
``tinyslam_tpu/models/vo.py:MapState, _match_to_map, _track_pnp, VOStats``).

World frame = camera frame of the first keyframe; poses are world->camera.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.geometry.pnp import pnp_refine
from tinyslam_tpu_torch.ops.hamming import match_descriptors
from tinyslam_tpu_torch.types import Features, from_numpy, to_numpy


@dataclass
class MapState:
    """Fixed-capacity landmark slotmap."""

    X: torch.Tensor          # (M, 3) world positions
    desc: torch.Tensor       # (M, 8) int32 packed BRIEF
    valid: torch.Tensor      # (M,) bool
    anchor_kf: torch.Tensor  # (M,) int32 keyframe that created the landmark
    obs_count: torch.Tensor  # (M,) int32 gated keyframe observations
    last_seen: torch.Tensor  # (M,) int32 keyframe of the last observation

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(capacity: int, device=None) -> "MapState":
        i32 = dict(dtype=torch.int32, device=device)
        return MapState(
            X=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            desc=torch.zeros((capacity, 8), **i32),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            anchor_kf=torch.full((capacity,), -1, **i32),
            obs_count=torch.zeros((capacity,), **i32),
            last_seen=torch.full((capacity,), -1, **i32),
        )

    @staticmethod
    def from_numpy(d: dict, device=None, prefix: str = "") -> "MapState":
        return MapState(**{f.name: from_numpy(d[prefix + f.name], device)
                           for f in dataclasses.fields(MapState)})

    def to_numpy(self, prefix: str = "") -> dict:
        return {prefix + f.name: to_numpy(getattr(self, f.name),
                                          desc=f.name == "desc")
                for f in dataclasses.fields(self)}


@dataclass
class VOStats:
    frame: int = 0
    num_features: int = 0
    num_matches: int = 0
    num_inliers: int = 0
    num_landmarks: int = 0
    is_keyframe: bool = False
    tracking: bool = False
    rmse_px: float = 0.0


def _match_to_map(feats: Features, map_state: MapState, max_distance: int,
                  ratio: float, cam: PinholeCamera | None = None,
                  R: torch.Tensor | None = None, t: torch.Tensor | None = None,
                  radius_px: float = 20.0):
    """Match features to the map.  With a predicted pose (cam, R, t) the
    matching is GUIDED: a map point is only eligible within ``radius_px`` of
    its predicted projection.  Returns (idx (N,) int32, valid (N,) bool)."""
    xy_a = proj = None
    if R is not None:
        pc = map_state.X @ R.T + t
        z = torch.clamp_min(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        in_front = pc[..., 2] > 1e-4
        # Behind-camera landmarks: park the projection far outside any radius.
        far = torch.full((), 1e7, dtype=torch.float32, device=pc.device)
        proj = torch.stack([torch.where(in_front, u, far),
                            torch.where(in_front, v, far)], dim=-1)
        xy_a = feats.xy
    m = match_descriptors(
        feats.desc, feats.valid, map_state.desc, map_state.valid,
        max_distance=max_distance, ratio=ratio, cross_check=True,
        xy_a=xy_a, proj_b=proj, radius_px=radius_px)
    return m["idx_b"], m["valid"]


def _track_pnp(cam: PinholeCamera, feats: Features, map_state: MapState,
               map_idx: torch.Tensor, match_valid: torch.Tensor,
               R0: torch.Tensor, t0: torch.Tensor, iters: int,
               inlier_px: float) -> dict:
    X = map_state.X[map_idx.long()]
    return pnp_refine(cam, X, feats.xy, match_valid, R0, t0,
                      iters=iters, inlier_px=inlier_px)
