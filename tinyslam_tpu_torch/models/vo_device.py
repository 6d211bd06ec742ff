"""Device-resident visual odometry: the tracked frame (mirrors
``tinyslam_tpu/models/vo_device.py:VOState, track_step, track_chunk,
DeviceVO``).

The JAX package compiles all per-frame control flow into ``lax.cond`` and
runs a chunk of frames as one ``lax.scan``.  Here the two data-dependent
decisions of a tracked frame are Python ``if`` statements on device
scalars: whether the last frame tracked, and whether the second PnP pass
runs.  A third read checks ``need_kf``, so each tracked frame synchronizes
with the device three times; everything else (pose update, velocity
model, adaptive threshold, summary row) stays on the device.

Ported: guided matching, two-pass PnP, pose/velocity update, adaptive
threshold.  Not ported yet, and raising ``NotImplementedError`` where the
JAX package would run them: relocalization (``last_tracking`` false),
keyframe insertion with windowed BA (``need_kf`` true) and the two-view
bootstrap that creates the first state.  ``VOState`` already carries every
field those parts use.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tinyslam_tpu_torch.config import SlamConfig
from tinyslam_tpu_torch.frontend.orb import adapt_threshold, extract_features
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.geometry.se3 import (
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
)
from tinyslam_tpu_torch.models.vo import MapState, VOStats, _match_to_map, _track_pnp
from tinyslam_tpu_torch.types import Features, from_numpy, to_numpy

# Ring of per-keyframe features (the keyframe slice uses it).
KF_RING = 32

_RELOC_TODO = ("relocalization (PnP-RANSAC after a lost frame) is not ported "
               "yet; see ROADMAP.md queue 1, relocalization")
_KEYFRAME_TODO = ("keyframe insertion with windowed BA is not ported yet; "
                  "see ROADMAP.md queue 1, keyframe insertion")
_BOOTSTRAP_TODO = ("the two-view bootstrap is not ported yet (ROADMAP.md "
                   "queue 1, bootstrap): assign DeviceVO.state a VOState "
                   "built from a seeded map first")

_TENSOR_FIELDS = ("win_R", "win_t", "win_obs", "win_mask", "win_valid",
                  "win_kf_id", "R", "t", "vel_R", "vel_t", "num_keyframes",
                  "frames_since_kf", "frame_idx", "last_tracking", "threshold")


@dataclass
class VOState:
    """Everything the tracker carries frame to frame, on one device."""

    map: MapState
    win_R: torch.Tensor        # (K, 3, 3)
    win_t: torch.Tensor        # (K, 3)
    win_obs: torch.Tensor      # (K, M, 2)
    win_mask: torch.Tensor     # (K, M) bool
    win_valid: torch.Tensor    # (K,) bool
    win_kf_id: torch.Tensor    # (K,) int32, -1 = free
    win_feats: Features        # per-slot keyframe features, leading dim K
    kf_ring: Features          # per-keyframe features, slot kf_id % KF_RING
    R: torch.Tensor            # (3, 3) current pose (world->camera)
    t: torch.Tensor            # (3,)
    vel_R: torch.Tensor        # (3, 3) constant-velocity model
    vel_t: torch.Tensor        # (3,)
    num_keyframes: torch.Tensor    # () int32
    frames_since_kf: torch.Tensor  # () int32
    frame_idx: torch.Tensor        # () int32
    last_tracking: torch.Tensor    # () bool
    threshold: torch.Tensor        # () float32 adaptive FAST threshold

    def replace(self, **kw) -> "VOState":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.R.device

    @staticmethod
    def empty(cfg: SlamConfig, device=None) -> "VOState":
        """A zero state with the config's static shapes."""
        K = cfg.ba.max_keyframes
        M = cfg.vo.max_map_points
        cap = cfg.frontend.max_features
        feats = Features.empty(cap, device)
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        eye = torch.eye(3, **f32)
        return VOState(
            map=MapState.empty(M, device),
            win_R=eye.expand(K, 3, 3).clone(),
            win_t=torch.zeros((K, 3), **f32),
            win_obs=torch.zeros((K, M, 2), **f32),
            win_mask=torch.zeros((K, M), dtype=torch.bool, device=device),
            win_valid=torch.zeros((K,), dtype=torch.bool, device=device),
            win_kf_id=torch.full((K,), -1, **i32),
            win_feats=feats.map(lambda x: x.expand(K, *x.shape).clone()),
            kf_ring=feats.map(lambda x: x.expand(KF_RING, *x.shape).clone()),
            R=eye.clone(), t=torch.zeros(3, **f32),
            vel_R=eye.clone(), vel_t=torch.zeros(3, **f32),
            num_keyframes=torch.zeros((), **i32),
            frames_since_kf=torch.zeros((), **i32),
            frame_idx=torch.zeros((), **i32),
            last_tracking=torch.zeros((), dtype=torch.bool, device=device),
            threshold=torch.tensor(cfg.frontend.threshold, **f32),
        )

    @staticmethod
    def seeded(cfg: SlamConfig, feats: Features, X: torch.Tensor,
               R: torch.Tensor, t: torch.Tensor) -> "VOState":
        """A tracking state at pose (R, t) whose map holds the valid
        features of one frame at the world points X (one row per valid
        feature, in slot order).  It stands in for the two-view bootstrap,
        which is not ported yet, as the JAX package's ``entry()`` seeds
        its map directly."""
        dev = feats.xy.device
        state = VOState.empty(cfg, dev)
        valid = feats.valid
        n = X.shape[0]
        if n > cfg.vo.max_map_points:
            raise ValueError(f"{n} seed points exceed max_map_points")
        m = state.map
        m.X[:n] = X.to(dev, torch.float32)
        m.desc[:n] = feats.desc[valid]
        m.valid[:n] = True
        return state.replace(R=R.to(dev, torch.float32).clone(),
                             t=t.to(dev, torch.float32).clone(),
                             last_tracking=torch.ones((), dtype=torch.bool,
                                                      device=dev))

    @staticmethod
    def from_numpy(d: dict, device=None) -> "VOState":
        """Build from a flat dict of numpy arrays keyed by field path
        (``"map.X"``, ``"win_feats.desc"``, ``"R"``, ...); ``uint32``
        descriptors are re-viewed as int32."""
        return VOState(
            map=MapState.from_numpy(d, device, "map."),
            win_feats=Features.from_numpy(d, device, "win_feats."),
            kf_ring=Features.from_numpy(d, device, "kf_ring."),
            **{k: from_numpy(d[k], device) for k in _TENSOR_FIELDS})

    def to_numpy(self) -> dict:
        """The flat dict of ``from_numpy``; descriptors come back ``uint32``."""
        out = {k: to_numpy(getattr(self, k)) for k in _TENSOR_FIELDS}
        out.update(self.map.to_numpy("map."))
        out.update(self.win_feats.to_numpy("win_feats."))
        out.update(self.kf_ring.to_numpy("kf_ring."))
        return out


# Packed per-frame summary layout (float32).
SUMMARY_FIELDS = (
    "num_features", "num_matches", "num_inliers", "tracking",
    "is_keyframe", "num_landmarks", "rmse_px", "threshold",
)


def _select(pred: torch.Tensor, a, b):
    """Elementwise ``pred ? a : b`` over matching (nested) tuples/dicts of
    tensors, with a 0-d bool ``pred`` that stays on the device."""
    if isinstance(a, dict):
        return {k: _select(pred, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_select(pred, x, y) for x, y in zip(a, b))
    return torch.where(pred, a, b)


def track_step(cam: PinholeCamera, cfg: SlamConfig, state: VOState,
               image: torch.Tensor) -> tuple[VOState, dict]:
    """One tracked frame.  Mirrors the tracking branch of the JAX
    ``track_step`` decision for decision.

    ``image`` (H, W) is float in [0, 1] or uint8, on the state's device.
    Returns the new state and {"R", "t", "summary"} (summary as in
    ``SUMMARY_FIELDS``).  Raises ``NotImplementedError`` where the JAX
    package would relocalize or insert a keyframe; ``state`` is then left
    as it was.
    """
    if image.dtype == torch.uint8:
        image = image.to(torch.float32) * (1.0 / 255.0)
    if not bool(state.last_tracking):                       # sync 1
        raise NotImplementedError(_RELOC_TODO)
    vo = cfg.vo
    feats = extract_features(image, state.threshold, cfg.frontend)
    threshold = state.threshold
    if cfg.frontend.adaptive_threshold:
        threshold = adapt_threshold(threshold, feats.count, feats.capacity,
                                    cfg.frontend.target_fill)

    R_pred, t_pred = se3_compose(state.vel_R, state.vel_t, state.R, state.t)
    idx, mvalid = _match_to_map(
        feats, state.map, cfg.matcher.max_distance, cfg.matcher.ratio,
        cam=cam, R=R_pred, t=t_pred, radius_px=vo.track_radius_px)
    out = _track_pnp(cam, feats, state.map, idx, mvalid, R_pred, t_pred,
                     iters=vo.pnp_iters, inlier_px=vo.pnp_inlier_px)

    if vo.track_two_pass:
        n1 = out["num_inliers"]
        if bool((n1 >= 15) & (n1 < vo.second_pass_below)):  # sync 2
            idx2, mvalid2 = _match_to_map(
                feats, state.map, cfg.matcher.max_distance, cfg.matcher.ratio,
                cam=cam, R=out["R"], t=out["t"], radius_px=8.0)
            out2 = _track_pnp(cam, feats, state.map, idx2, mvalid2,
                              out["R"], out["t"], iters=vo.pnp_iters,
                              inlier_px=vo.pnp_inlier_px)
            better = (mvalid2.sum() >= mvalid.sum()) & (
                out2["num_inliers"] >= out["num_inliers"])
            idx, mvalid, out = _select(better, (idx2, mvalid2, out2),
                                       (idx, mvalid, out))

    n_in = out["num_inliers"]
    pose_finite = torch.isfinite(out["R"]).all() & torch.isfinite(out["t"]).all()
    tracking = (n_in >= 20) & pose_finite & (out["rmse"] < 3.0 * vo.pnp_inlier_px)

    # Accept: update the pose and the low-passed constant-velocity model.
    Ri, ti = se3_inverse(state.R, state.t)
    Rv_new, tv_new = se3_compose(out["R"], out["t"], Ri, ti)
    xi = 0.6 * se3_log(Rv_new, tv_new) + 0.4 * se3_log(state.vel_R, state.vel_t)
    vel_R_acc, vel_t_acc = se3_exp(xi)
    vel_id_R, vel_id_t = se3_identity(device=image.device)
    use_vel = tracking & state.last_tracking
    frames_since_kf = state.frames_since_kf + 1
    new_state = state.replace(
        R=torch.where(tracking, out["R"], state.R),
        t=torch.where(tracking, out["t"], state.t),
        vel_R=torch.where(use_vel, vel_R_acc, vel_id_R),
        vel_t=torch.where(use_vel, vel_t_acc, vel_id_t),
        last_tracking=tracking,
        frames_since_kf=frames_since_kf,
        frame_idx=state.frame_idx + 1,
        threshold=threshold,
    )

    need_kf = tracking & (
        (frames_since_kf >= vo.keyframe_max_interval)
        | ((n_in < vo.keyframe_min_inliers)
           & (frames_since_kf >= vo.keyframe_min_interval))
        | (n_in < vo.keyframe_critical_inliers))
    if bool(need_kf):                                        # sync 3
        raise NotImplementedError(_KEYFRAME_TODO)

    summary = torch.stack([
        feats.count.to(torch.float32),
        mvalid.sum().to(torch.float32),
        n_in.to(torch.float32),
        tracking.to(torch.float32),
        need_kf.to(torch.float32),
        new_state.map.valid.sum().to(torch.float32),
        out["rmse"],
        threshold,
    ])
    return new_state, {"R": new_state.R, "t": new_state.t, "summary": summary}


def track_chunk(cam: PinholeCamera, cfg: SlamConfig, state: VOState,
                images: torch.Tensor, active) -> tuple[VOState, dict]:
    """Track a (B, H, W) chunk of frames.

    ``active`` (B,) bool (host list or tensor) masks padding frames at the
    tail of a sequence: an inactive step leaves the state as it is and
    records a zero summary.  Returns the final state and {"R" (B, 3, 3),
    "t" (B, 3), "summary" (B, len(SUMMARY_FIELDS))}.
    """
    active = torch.as_tensor(active).tolist()
    Rs, ts, summaries = [], [], []
    for image, act in zip(images, active):
        if act:
            state, ys = track_step(cam, cfg, state, image)
        else:
            ys = {"R": state.R, "t": state.t,
                  "summary": torch.zeros(len(SUMMARY_FIELDS), dtype=torch.float32,
                                         device=state.device)}
        Rs.append(ys["R"])
        ts.append(ys["t"])
        summaries.append(ys["summary"])
    return state, {"R": torch.stack(Rs), "t": torch.stack(ts),
                   "summary": torch.stack(summaries)}


@dataclass
class DeviceVO:
    """Host shell around the tracker: frames are buffered and tracked a
    chunk at a time; per-frame poses and summaries reach the host only in
    ``flush``.

    The two-view bootstrap is not ported yet, so the first state is handed
    over by assigning ``vo.state`` (as ``utils/checkpoint.py`` restores a
    JAX ``DeviceVO``)::

        vo = DeviceVO(cfg, camera, chunk=8)
        vo.state = VOState.from_numpy(seed, device="cuda")
        for frame in frames:
            vo.process(frame)
        vo.flush()
        traj = vo.positions        # (T, 3) camera centres
    """

    cfg: SlamConfig
    camera: PinholeCamera
    chunk: int = 16

    def __post_init__(self):
        if not isinstance(self.cfg, SlamConfig):
            raise TypeError("cfg must be a SlamConfig")
        if not 1 <= self.chunk <= KF_RING:
            raise ValueError(f"chunk={self.chunk} outside 1..KF_RING={KF_RING}")
        self.state: VOState | None = None
        self._buf: list = []
        self._pending: list[tuple[int, dict]] = []
        self.trajectory: list[tuple[np.ndarray, np.ndarray]] = []
        self.stats: list[VOStats] = []

    def process(self, image) -> None:
        """Queue one (H, W) frame (numpy array or tensor); a full chunk is
        tracked at once."""
        if self.state is None:
            raise NotImplementedError(_BOOTSTRAP_TODO)
        self._buf.append(image)
        if len(self._buf) >= self.chunk:
            self._dispatch()

    def _dispatch(self) -> None:
        n = len(self._buf)
        if n == 0:
            return
        dev = self.state.device
        buf = self._buf + [self._buf[-1]] * (self.chunk - n)
        if all(isinstance(im, np.ndarray) for im in buf):
            images = torch.from_numpy(np.stack(buf)).to(dev)   # one upload
        else:
            images = torch.stack([torch.as_tensor(im, device=dev) for im in buf])
        active = [True] * n + [False] * (self.chunk - n)
        self._buf = []
        self.state, ys = track_chunk(self.camera, self.cfg, self.state,
                                     images, active)
        self._pending.append((n, ys))

    def flush(self) -> None:
        """Track any partial chunk and bring all pending poses and summaries
        to the host."""
        self._dispatch()
        for n, ys in self._pending:
            R = ys["R"][:n].cpu().numpy()
            t = ys["t"][:n].cpu().numpy()
            s = ys["summary"][:n].cpu().numpy()
            base = len(self.stats)
            for i in range(n):
                self.trajectory.append((R[i], t[i]))
                self.stats.append(VOStats(
                    frame=base + i,
                    num_features=int(s[i, 0]), num_matches=int(s[i, 1]),
                    num_inliers=int(s[i, 2]), tracking=bool(s[i, 3]),
                    is_keyframe=bool(s[i, 4]), num_landmarks=int(s[i, 5]),
                    rmse_px=float(s[i, 6]),
                ))
        self._pending = []

    def run(self, images) -> list[VOStats]:
        for im in images:
            self.process(im)
        self.flush()
        return self.stats

    @property
    def positions(self) -> np.ndarray:
        """Camera centres (world frame); call flush() first."""
        return np.asarray([-R.T @ t for R, t in self.trajectory])
