"""The kernels' roofline shares at a cell's own shapes: the least time the
card could take for the work (``counts/``), over the device time of many
launches of the port's kernel on the cell's frames, between CUDA events."""

from __future__ import annotations

import json
from pathlib import Path

import torch

from slambench import trace
from slambench.harness import load_module

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def _gray(frames: torch.Tensor) -> torch.Tensor:
    return frames.to(torch.float32) * (1.0 / 255.0)


def k1(frames: torch.Tensor, threshold: torch.Tensor, fe, reps: int) -> dict:
    """K1 (``fast_pyramid_maps``) over the (B, H, W) uint8 ``frames`` at the
    (B,) or 0-d ``threshold``, one launch a call, as the tracker calls it
    (B = 1: one frame's pyramid)."""
    from tinyslam_tpu_torch.ops.fast_cuda import fast_pyramid_maps
    from tinyslam_tpu_torch.ops.image import build_pyramid

    gray = _gray(frames[0] if frames.shape[0] == 1 else frames)
    levels = build_pyramid(gray, fe.num_levels)
    thr = threshold.reshape(-1).to(torch.float32)
    ms = trace.launch_ms(lambda: fast_pyramid_maps(levels, thr, fe.border, fe.streak_length,
                                                   fe.blur_sigma), reps)
    shapes = [tuple(lvl.shape[-2:]) for lvl in levels]
    least = load_module("counts", "k1").least_s(shapes, PEAKS, frames=frames.shape[0],
                                                thresholds=thr.numel())
    return {"ms": ms, "least_ms": least * 1e3}


def k2(frames: torch.Tensor, threshold: torch.Tensor, cfg, cam, map_state, R, t,
       reps: int) -> dict:
    """K2 (``match_reduce``) at the guided shape of the tracked frame: the
    features of ``frames`` (B, H, W) against the state's map, gated around
    the map's projections at pose (R, t) within ``track_radius_px``."""
    from tinyslam_tpu_torch.frontend.orb import extract_batch, extract_features
    from tinyslam_tpu_torch.ops.match_cuda import match_reduce

    if frames.shape[0] == 1:
        feats = extract_features(frames[0], threshold.reshape(()), cfg.frontend)
    else:
        feats = extract_batch(frames, threshold.reshape(-1), cfg.frontend)
    pc = map_state.X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp_min(pc[..., 2], 1e-6)
    far = torch.full((), 1e7, dtype=torch.float32, device=pc.device)
    proj = torch.stack([torch.where(pc[..., 2] > 1e-4, cam.fx * pc[..., 0] / z + cam.cx, far),
                        torch.where(pc[..., 2] > 1e-4, cam.fy * pc[..., 1] / z + cam.cy, far)],
                       -1)
    radius = cfg.vo.track_radius_px
    ms = trace.launch_ms(lambda: match_reduce(feats.desc, feats.valid, map_state.desc,
                                              map_state.valid, xy_a=feats.xy, proj_b=proj,
                                              radius_px=radius), reps)
    n, m = feats.desc.shape[-2], map_state.desc.shape[-2]
    batch = feats.desc.shape[0] if feats.desc.dim() == 3 else 1
    least = load_module("counts", "k2").least_s(n, m, PEAKS, batch=batch)
    return {"ms": ms, "least_ms": least * 1e3}
