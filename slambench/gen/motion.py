"""Closed camera laps: the port's ``data/synthetic.py`` trajectories
(``mav_trajectory``) made periodic.

Every periodic term completes whole cycles in ``lap_frames`` frames and the
jitter is a smoothed random walk whose steps sum to zero over the lap, so
frame ``lap_frames`` has frame 0's pose and a window can run lap after lap
with no reset.  Poses are world->camera (R, t) with +z forward, +x right
and +y down, in float32; the jitter is drawn from numpy's generator.
"""

from __future__ import annotations

import numpy as np


def look_at(camera_pos: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    fwd = target - camera_pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    return R, -R @ camera_pos


def periodic_walk(rng: np.random.Generator, n: int, dims: int, sigma: float,
                  window: int) -> np.ndarray:
    """(n, dims) zero-mean smooth random walk of period n: white steps with
    their mean taken out (so the walk returns to its start), summed, then
    box-smoothed around the circle."""
    steps = rng.normal(0.0, sigma, (n, dims))
    walk = np.cumsum(steps - steps.mean(axis=0), axis=0)
    pad = np.concatenate([walk[-window:], walk, walk[:window]])
    kernel = np.ones(window) / window
    sm = np.stack([np.convolve(pad[:, k], kernel, mode="same")[window:window + n]
                   for k in range(dims)], -1)
    return sm - sm.mean(axis=0)


def mav_lap(rng: np.random.Generator, lap_frames: int, index: np.ndarray, radius: float,
            target,
            start_rad: float, jitter_pos: float, jitter_tgt: float, height: float,
            height_amp: float, height_cycles: int, nod_cycles: int):
    """A EuRoC-MH-like lap: one circle of the hall at ``radius``, yaw ahead
    of the track (a MAV looks into the turn), strong height changes of
    ``height_cycles`` cycles and a look-target nod of ``nod_cycles``."""
    tgt0 = np.asarray(target, np.float64)
    jp = periodic_walk(rng, lap_frames, 3, jitter_pos, 20)
    jt = periodic_walk(rng, lap_frames, 3, jitter_tgt, 25)
    phase = 2.0 * np.pi * (index % lap_frames) / lap_frames
    poses = []
    for i, k in enumerate(index % lap_frames):
        a = start_rad + phase[i]
        h = height + height_amp * np.sin(height_cycles * phase[i])
        pos = np.array([radius * np.sin(a), h, -radius * np.cos(a)]) + tgt0
        look = tgt0 + np.array([1.2 * np.sin(a + 0.3), 0.3 * np.sin(nod_cycles * phase[i]),
                                -1.2 * np.cos(a + 0.3)]) * 0.3
        poses.append(look_at(pos + jp[k], look + jt[k]))
    return poses


LAPS = {"mav": mav_lap}


def lap_poses(scene_seed: int, lap_frames: int, kind: str, params: dict,
              frames: int | None = None):
    """(R (n, 3, 3), t (n, 3)) float32 of the first ``frames`` frames (one
    lap if None) of the lap ``kind`` with ``params``, its jitter drawn from
    ``scene_seed``; frame i + lap_frames is frame i."""
    rng = np.random.default_rng(int(scene_seed))
    poses = LAPS[kind](rng, int(lap_frames), np.arange(frames or lap_frames), **params)
    R = np.stack([p[0] for p in poses]).astype(np.float32)
    t = np.stack([p[1] for p in poses]).astype(np.float32)
    return R, t
