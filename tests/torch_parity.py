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


def _config(c, keyframes: bool, ba: dict):
    vo = dict(max_map_points=MAP_POINTS, **({} if keyframes else NO_KEYFRAMES))
    return c.SlamConfig(frontend=c.FrontendConfig(**FRONTEND), vo=c.VOConfig(**vo),
                        ba=c.BAConfig(**ba))


def torch_config(keyframes: bool = False, **ba):
    """The port's SlamConfig of the small set-up (no JAX import); ``ba``
    overrides BAConfig fields."""
    from tinyslam_tpu_torch import config as tc

    return _config(tc, keyframes, ba)


def configs(keyframes: bool = False, **ba):
    """(JAX SlamConfig, torch SlamConfig) of the small set-up."""
    from tinyslam_tpu import config as jc

    return _config(jc, keyframes, ba), torch_config(keyframes, **ba)


FEATURE_FIELDS = ("xy", "level", "angle", "score", "desc", "valid")


def features_numpy(f) -> dict:
    """The JAX package's Features as a dict of numpy arrays (uint32 desc)."""
    return {k: np.asarray(getattr(f, k)) for k in FEATURE_FIELDS}


def jax_features(d: dict):
    """The JAX package's Features from a dict of numpy arrays."""
    import jax.numpy as jnp
    from tinyslam_tpu.types import Features

    return Features(**{k: jnp.asarray(d[k]) for k in FEATURE_FIELDS})


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


def out_and_back_tum(root, n_out: int):
    """The orbit's frames 0..n_out-1, then n_out-2..0, with real-camera
    photometrics, written in the TUM layout under ``root`` by the port's
    writer; returns ``root``."""
    from tinyslam_tpu_torch.data.synthetic import apply_photometrics, write_tum_sequence

    frames, poses, _ = orbit(n_out)
    frames, poses = frames + frames[-2::-1], poses + poses[-2::-1]
    rng = np.random.default_rng(8)
    images = [apply_photometrics(f, rng, exposure=1.0 + 0.005 * (i % 7))
              for i, f in enumerate(frames)]
    write_tum_sequence(root, images, poses)
    return root


def small_tools(monkeypatch, native_dir, loop_min_gap: int, *port_modules):
    """The JAX package's tools and the port's ``port_modules`` on the small
    set-up with keyframes and ``loop_min_gap``: ``SlamConfig`` and
    ``FR1_INTRINSICS`` replaced in their namespaces; the JAX loader through
    a private build of its native sources in ``native_dir``."""
    import tinyslam_tpu.config as jconfig
    import tinyslam_tpu.data.tum as jtum
    import tinyslam_tpu.models  # noqa: F401  (imported before its SlamConfig is replaced)
    import tinyslam_tpu.native as jn

    jcfg, tcfg = (dataclasses.replace(c, pose_graph=dataclasses.replace(
        c.pose_graph, loop_min_gap=loop_min_gap)) for c in configs(keyframes=True))
    monkeypatch.setattr(jconfig, "SlamConfig", lambda: jcfg)
    monkeypatch.setattr(jtum, "FR1_INTRINSICS", CAMERA)
    for mod in port_modules:
        monkeypatch.setattr(mod, "SlamConfig", lambda: tcfg)
        monkeypatch.setattr(mod, "FR1_INTRINSICS", CAMERA)
    monkeypatch.setattr(jn, "_SO", jax_native_library(native_dir))
    monkeypatch.setattr(jn, "_lib", None)


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


class JaxSampler:
    """The port's ``Sampler`` interface, replaying the JAX package's
    ``jax.random`` streams, so that a parity test gives both packages the
    same RANSAC samples.  ``key`` names the stream as the port's callers
    do: ``("two_view", seed, "E" or "H")`` is ``split(PRNGKey(seed))``'s
    first or second key (``TwoViewEstimator.estimate``), ``("reloc",
    frame_idx)`` is ``fold_in(PRNGKey(17), frame_idx)`` (the device
    tracker's relocalization), ``("host_reloc", frame_idx)`` is
    ``PRNGKey(frame_idx)`` (``VisualOdometry``'s relocalization) and
    ``("loop", kf_id * 131 + old_id)`` is ``fold_in(PRNGKey(23), n)`` (the
    loop probe's PnP-RANSAC).  ``key_offset`` k adds 1000 k to every
    ``PRNGKey`` seed, as ``tools/jax_reference_orbit.py --key-offset k``
    does to the JAX package.  ``calls`` lists the keys drawn, in order."""

    def __init__(self, key_offset: int = 0):
        self.key_offset = key_offset
        self.calls: list = []

    def _key(self, key):
        import jax

        self.calls.append(tuple(int(k) if isinstance(k, torch.Tensor) else k
                                for k in key))
        kind, n = key[0], int(key[1])
        prng = lambda seed: jax.random.PRNGKey(seed + 1000 * self.key_offset)  # noqa: E731
        if kind == "two_view":
            return jax.random.split(prng(n))[0 if key[2] == "E" else 1]
        if kind == "reloc":
            return jax.random.fold_in(prng(17), n)
        if kind == "host_reloc":
            return prng(n)
        if kind == "loop":
            return jax.random.fold_in(prng(23), n)
        raise KeyError(key)

    def uniform(self, shape, device, key=None) -> torch.Tensor:
        import jax

        u = np.array(jax.random.uniform(self._key(key), tuple(shape)))
        return torch.from_numpy(u).to(device)

    def choice(self, valid: torch.Tensor, shape, key=None) -> torch.Tensor:
        """``jax.random.categorical`` over the true entries of ``valid``,
        as ``pnp_ransac`` draws its samples."""
        import jax
        import jax.numpy as jnp

        logits = jnp.where(jnp.asarray(valid.cpu().numpy()), 0.0, -1e9)
        idx = jax.random.categorical(self._key(key), logits[None, :], axis=-1,
                                     shape=tuple(shape))
        return torch.from_numpy(np.array(idx)).long().to(valid.device)


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


def dense_graph_terms(kind: str, seed: int = 0):
    """Gauss-Newton terms of a pose graph whose edges pile onto a few node
    pairs (half of them onto one), as ``normal_equations`` takes them:
    (n, D, r (E, D), Ji, Jj (E, D, D), w (E,), bi, bj (E,)), float32 with
    magnitudes spread over six decades, so that any change of the order of
    the additions changes the rounding.  ``kind``: "se3" (D 6) or "sim3" (D
    7) over 16 nodes; "coarse" and "fine", the block and window ids of
    ``parallel/dist_pose_graph.py``'s node-sharded solver (64 nodes in 4
    shards of 16, halo 8), with its Jacobian columns masked as it masks
    them; "padded" (D 7), a 32-node graph padded to 128 edges as
    ``models/slam.py:solve_graph`` pads it (``padded_graph_terms``)."""
    if kind == "padded":
        return padded_graph_terms(seed)
    rng = np.random.default_rng(seed)
    E, n, D = 240, 16, 7 if kind == "sim3" else 6
    if kind in ("coarse", "fine"):
        n = 64
    ei = rng.integers(0, n, E)
    ej = np.minimum(ei + rng.integers(1, 4, E), n - 1)
    ei[: E // 2], ej[: E // 2] = 3, 4
    ei, ej = torch.from_numpy(ei), torch.from_numpy(ej)

    def values(*shape):
        x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)
        return torch.from_numpy(x.astype(np.float32))

    r, Ji, Jj, w = values(E, D), values(E, D, D), values(E, D, D), values(E).abs()
    if kind == "coarse":
        B = n // 4
        bi, bj = torch.clamp(ei // B, 0, 3), torch.clamp(ej // B, 0, 3)
        Ji, Jj = Ji * (bi != 0)[:, None, None], Jj * (bj != 0)[:, None, None]
        return 4, D, r, Ji, Jj, w, bi, bj
    if kind == "fine":
        W, win0 = 16 + 2 * 8, 16 - 8            # shard 1's window
        wi, wj = ei - win0, ej - win0
        Ji = Ji * ((wi >= 0) & (wi < W) & (ei != 0))[:, None, None]
        Jj = Jj * ((wj >= 0) & (wj < W) & (ej != 0))[:, None, None]
        return W, D, r, Ji, Jj, w, torch.clamp(wi, 0, W - 1), torch.clamp(wj, 0, W - 1)
    return n, D, r, Ji, Jj, w, ei, ej


def padded_graph_terms(seed: int = 0, n: int = 32, valid: int = 30, E: int = 128):
    """``dense_graph_terms``'s tuple for a Sim(3) graph of ``n`` nodes whose
    ``valid`` edges (a chain from node 0 and two loop edges onto it; terms
    over six decades) are padded to ``E`` as ``solve_graph`` pads them:
    i = j = 0 and an identity measurement, weighted by valid = 0, with the
    residual and Jacobians the solver computes for them at a node-0 pose.
    Every padded edge adds four terms (+-0) to each slot of H's (0, 0)
    block and two to node 0's rows of g: segments of 4 (E - valid) + a few."""
    from tinyslam_tpu_torch.backend.pose_graph import edge_jacobians
    from tinyslam_tpu_torch.geometry.sim3 import sim3_exp

    rng = np.random.default_rng(seed)
    D, pad = 7, E - valid
    ei = np.concatenate([np.arange(valid - 2), [0, 0], np.zeros(pad, np.int64)])
    ej = np.concatenate([np.arange(1, valid - 1), [valid // 2, n - 1], np.zeros(pad, np.int64)])

    def values(*shape):
        x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)
        return torch.from_numpy(x.astype(np.float32))

    r, Ji, Jj = values(valid, D), values(valid, D, D), values(valid, D, D)
    R0, t0, s0 = sim3_exp(torch.from_numpy(rng.normal(0, 0.5, (1, 7)).astype(np.float32)))
    node0 = (R0.expand(pad, 3, 3), t0.expand(pad, 3), s0.expand(pad))
    eye = (torch.eye(3).expand(pad, 3, 3), torch.zeros(pad, 3), torch.ones(pad))
    r_pad, Ji_pad, Jj_pad = edge_jacobians(node0, node0, eye)
    w = torch.cat([values(valid).abs(), torch.ones(pad)]) * torch.from_numpy(
        np.arange(E) < valid).float()
    return (n, D, torch.cat([r, r_pad]), torch.cat([Ji, Ji_pad]), torch.cat([Jj, Jj_pad]), w,
            torch.from_numpy(ei).long(), torch.from_numpy(ej).long())


def jax_native_library(directory):
    """The JAX package's native library (``tinyslam_tpu/native/``'s sources,
    its Makefile's flags) compiled into ``directory``.  Parity tests point
    ``tinyslam_tpu.native._SO`` at it: the package itself builds in place
    on first use, which races with its own tests under several workers."""
    import subprocess
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "tinyslam_tpu" / "native"
    out = Path(directory) / "libtinyslam_native.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", str(src / "decode.cpp"),
                    str(src / "loader.cpp"), "-shared", "-lz", "-lpthread", "-o", str(out)],
                   check=True, capture_output=True)
    return out



# The multi-sequence set-up (tests/test_torch_multiseq.py, the card test of
# tests/test_torch_cuda.py): three sequences seeded at these orbit frames,
# MULTI_FRAMES frames each; sequence LOST_SEQ starts lost, MULTI_INACTIVE
# frames at the end of sequence 2 are padding.
MULTI_STARTS = (0, 3, 6)
MULTI_FRAMES = 8
LOST_SEQ = 1
MULTI_INACTIVE = 2


def lost_state(seed: dict, yaw: float) -> dict:
    """The seeded state marked lost, its stale pose turned by ``yaw`` rad
    about the camera's vertical axis (``test_torch_reloc.py``'s
    construction)."""
    from tinyslam_tpu_torch.geometry.se3 import so3_exp

    d = dict(seed)
    dR = so3_exp(torch.tensor([0.0, yaw, 0.0])).numpy()
    d["R"] = (dR @ seed["R"]).astype(np.float32)
    d["t"] = (dR @ seed["t"]).astype(np.float32)
    d["last_tracking"] = np.asarray(False)
    d["frame_idx"] = np.asarray(9, np.int32)
    return d


def multi_sequences(frames, poses, room, features_of, tcfg):
    """(seeds, images (B, C, H, W), active (B, C)) of the multi-sequence
    set-up: ``seeds`` are flat numpy states from ``features_of(frame)`` (a
    features dict: the JAX package's or the port's).  The lost sequence
    tracks from its own seed frame (0.6 rad off, the global fallback
    re-acquires), the others from the frame after theirs."""
    seeds, images = [], []
    for b, s0 in enumerate(MULTI_STARTS):
        seed = seeded_state(tcfg, features_of(frames[s0]), room, poses[s0])
        first = s0 if b == LOST_SEQ else s0 + 1
        seeds.append(lost_state(seed, 0.6) if b == LOST_SEQ else seed)
        images.append(np.stack(frames[first:first + MULTI_FRAMES]))
    active = np.ones((len(MULTI_STARTS), MULTI_FRAMES), bool)
    active[2, -MULTI_INACTIVE:] = False
    return seeds, np.stack(images), active
