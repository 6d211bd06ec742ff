"""One lap of 8-bit frames, rendered on the device from the seed.

The workload fixes the world: the room (its textures and clutter, drawn
from the workload's ``scene_seed``) and the lap's path and jitter.  The
run's ``--seed`` draws what differs between two passes of a real camera
over the same patrol: the auto-exposure hunting and the sensor noise (and,
in the traffic drivers, the port's RANSAC draws).  So every seed asks for
the same kind and amount of work.

The photometrics are those of the port's ``data/synthetic.py``:
vignetting, a smooth per-frame exposure gain, Gaussian sensor noise and
8-bit quantisation; with ``supersample`` k, each pixel averages k x k
rays.  Frames are rendered through an undistorted pinhole,
which is what a dataset's frames are after the loader's undistortion.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.gen.motion import lap_poses, periodic_walk
from slambench.gen.scene import Room

RENDER_BATCH = 16


def exposure_track(seed: int, n: int, amp: float) -> np.ndarray:
    """Smooth per-frame exposure gains around 1.0 of period ``n``."""
    rng = np.random.default_rng(int(seed))
    return 1.0 + periodic_walk(rng, n, 1, amp / 8, 30)[:, 0].clip(-amp, amp)


def render_lap(traffic: dict, camera: dict, seed: int, device) -> dict:
    """The lap of ``traffic`` (its ``scene``, ``lap`` and ``photometric``
    groups) seen through ``camera`` (fx, fy, cx, cy, width, height).
    Returns {"frames" (L, H, W) uint8 on ``device``, "R" (L, 3, 3), "t" (L, 3)
    float32 numpy world->camera poses, "room": the ``Room``}."""
    dev = torch.device(device)
    scene, lap, photo = traffic["scene"], traffic["lap"], traffic["photometric"]
    room = Room(scene["scene_seed"], dev, **{k: v for k, v in scene.items()
                                             if k != "scene_seed"})
    R, t = lap_poses(scene["scene_seed"], lap["lap_frames"], lap["kind"], lap["params"])
    W, H = int(camera["width"]), int(camera["height"])
    L = len(R)
    gains = torch.from_numpy(exposure_track(seed, L, photo["exposure_amp"])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2**63)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    r2 = (((xx - W / 2) / (W / 2)) ** 2 + ((yy - H / 2) / (H / 2)) ** 2) / 2.0
    vignette = 1.0 - photo["vignette"] * r2
    frames = torch.empty((L, H, W), dtype=torch.uint8, device=dev)
    Rt, tt = torch.from_numpy(R), torch.from_numpy(t)
    k = int(photo.get("supersample", 1))
    # k x k rays a pixel, averaged: the pixel's area integrates the scene,
    # as a sensor's does, so texture finer than a pixel does not alias.
    fine = dict(camera, fx=camera["fx"] * k, fy=camera["fy"] * k,
                cx=camera["cx"] * k + (k - 1) / 2, cy=camera["cy"] * k + (k - 1) / 2)
    for s in range(0, L, RENDER_BATCH):
        e = min(s + RENDER_BATCH, L)
        img = room.render(fine, Rt[s:e], tt[s:e], W * k, H * k)
        if k > 1:
            img = torch.nn.functional.avg_pool2d(img[:, None], k)[:, 0]
        img = img * vignette * gains[s:e, None, None].float()
        img = img + photo["noise_std"] * torch.randn(img.shape, generator=gen, device=dev)
        frames[s:e] = torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return {"frames": frames, "R": R, "t": t, "room": room}
