"""Shared set-up of the parity tests between the JAX package (the
reference, on the CPU) and its PyTorch port.

Everything is small: 160x120 frames, 2 pyramid levels of 128 features and
512 map points, on the bench's orbit through a textured room.  Inputs are
numpy arrays made from seeds and handed to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# tier-1 runs several pytest workers at once; keep each one's torch small.
torch.set_num_threads(2)

WIDTH, HEIGHT = 160, 120
CAMERA = dict(fx=130.0, fy=130.0, cx=79.5, cy=59.5)
FRONTEND = dict(height=HEIGHT, width=WIDTH, num_levels=2, features_per_level=128)
MAP_POINTS = 512
# Keyframe insertion off through existing fields: need_kf is always false.
NO_KEYFRAMES = dict(keyframe_min_inliers=0, keyframe_critical_inliers=0,
                    keyframe_max_interval=2**30)


def torch_config(keyframes: bool = False):
    """The port's SlamConfig of the small set-up (no JAX import)."""
    from tinyslam_tpu_torch import config as tc

    vo = dict(max_map_points=MAP_POINTS, **({} if keyframes else NO_KEYFRAMES))
    return tc.SlamConfig(frontend=tc.FrontendConfig(**FRONTEND), vo=tc.VOConfig(**vo))


def configs(keyframes: bool = False):
    """(JAX SlamConfig, torch SlamConfig) of the small set-up."""
    from tinyslam_tpu import config as jc

    vo = dict(max_map_points=MAP_POINTS, **({} if keyframes else NO_KEYFRAMES))
    return (jc.SlamConfig(frontend=jc.FrontendConfig(**FRONTEND), vo=jc.VOConfig(**vo)),
            torch_config(keyframes))


def cameras():
    from tinyslam_tpu.geometry.camera import PinholeCamera as JCam
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera as TCam

    return JCam.create(**CAMERA), TCam.create(**CAMERA)


def orbit(n_frames: int):
    """(frames, poses, room) of the bench orbit, rendered by the port."""
    from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera

    room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
    poses = orbit_trajectory(n_frames, radius=2.0, step=0.02, start=-0.35,
                             target=(0.0, 0.0, 2.0))
    cam = PinholeCamera.create(**CAMERA)
    return [room.render(cam, R, t, WIDTH, HEIGHT) for R, t in poses], poses, room


def seeded_state(tcfg, feats: dict, room, pose) -> dict:
    """Flat numpy VOState: the map holds the valid features of one frame at
    their ray-cast ground-truth 3D points, the pose is that frame's."""
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models.vo_device import VOState
    from tinyslam_tpu_torch.types import Features

    f = Features.from_numpy(feats)
    xy = f.xy[f.valid].numpy().astype(np.float64)
    X = room.raycast(PinholeCamera.create(**CAMERA), *pose, xy)
    R, t = (torch.from_numpy(np.asarray(a, np.float32)) for a in pose)
    return VOState.seeded(tcfg, f, torch.from_numpy(X.astype(np.float32)),
                          R, t).to_numpy()


def jax_state(d: dict):
    """The JAX package's VOState from a flat numpy dict."""
    import jax.numpy as jnp
    from tinyslam_tpu.models.vo import MapState
    from tinyslam_tpu.models.vo_device import VOState
    from tinyslam_tpu.types import Features

    def sub(cls, prefix):
        return cls(**{f.name: jnp.asarray(d[prefix + f.name])
                      for f in dataclasses.fields(cls)})

    nested = {"map": sub(MapState, "map."), "win_feats": sub(Features, "win_feats."),
              "kf_ring": sub(Features, "kf_ring.")}
    rest = {f.name: jnp.asarray(d[f.name]) for f in dataclasses.fields(VOState)
            if f.name not in nested}
    return VOState(**nested, **rest)


def rand_desc(rng, n, dup_frac=0.2):
    """Random packed descriptors with deliberate duplicates (tie-breaks)."""
    d = rng.integers(0, 2**32 - 1, (n, 8), np.uint32)
    ndup = int(n * dup_frac)
    if ndup:
        d[rng.integers(0, n, ndup)] = d[rng.integers(0, n, ndup)]
    return d


def perturb(rng, d, flips=8):
    """Flip a few bits of each descriptor (Hamming ~flips: matchable)."""
    out = d.copy()
    for _ in range(flips):
        word = rng.integers(0, 8, len(out))
        bit = rng.integers(0, 32, len(out))
        out[np.arange(len(out)), word] ^= (np.uint32(1) << bit).astype(np.uint32)
    return out
