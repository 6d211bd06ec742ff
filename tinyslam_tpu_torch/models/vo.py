"""Landmark map, tracking helpers, map maintenance, relocalization and
the host-stepped visual odometry (mirrors ``tinyslam_tpu/models/vo.py``).

World frame = camera frame of the first keyframe; poses are world->camera.
Monocular scale is fixed at bootstrap by normalizing the median depth.

Two reference behaviours of the JAX CPU path are kept on purpose, for
parity: a scatter with repeated indices keeps the LAST row's write
(``_last_writer``; torch leaves the order of ``index_put_`` undefined),
and a median over an even count averages the two middle values, as
``jnp.nanmedian`` does (``ops/stats.py``'s ``nanmedian``; ``torch.nanmedian``
takes the lower).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tinyslam_tpu_torch.backend.ba import bundle_adjust
from tinyslam_tpu_torch.config import SlamConfig
from tinyslam_tpu_torch.frontend.orb import OrbFrontend
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.geometry.epipolar import depths, triangulate
from tinyslam_tpu_torch.geometry.pnp import pnp_ransac, pnp_refine
from tinyslam_tpu_torch.geometry.se3 import (
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
)
from tinyslam_tpu_torch.models.two_view import TwoViewEstimator
from tinyslam_tpu_torch.ops.dupband_cuda import dup_band
from tinyslam_tpu_torch.ops.hamming import match_descriptors
from tinyslam_tpu_torch.ops.stats import nanmedian
from tinyslam_tpu_torch.types import Features, from_numpy, row, set_row, to_numpy
from tinyslam_tpu_torch.utils.cuda_graph import device_cond
from tinyslam_tpu_torch.utils.draws import Sampler


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
                  radius_px: float = 20.0, span: str | None = None):
    """Match features to the map.  With a predicted pose (cam, R, t) the
    matching is GUIDED: a map point is only eligible within ``radius_px`` of
    its predicted projection.  Returns (idx (N,) int32, valid (N,) bool).
    ``span`` names K2's span in a captured step (``match_descriptors``).

    A leading B on the features, the map and the pose matches B sequences
    at once (one K2 launch), each guided by its own pose."""
    xy_a = proj = None
    if R is not None:
        pc = map_state.X @ R.transpose(-1, -2) + t[..., None, :]
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
        xy_a=xy_a, proj_b=proj, radius_px=radius_px, span=span)
    return m["idx_b"], m["valid"]


def _track_pnp(cam: PinholeCamera, feats: Features, map_state: MapState,
               map_idx: torch.Tensor, match_valid: torch.Tensor,
               R0: torch.Tensor, t0: torch.Tensor, iters: int,
               inlier_px: float) -> dict:
    """``pnp_refine`` of the matched map points; with a leading B, each
    sequence's features against its own map, from its own pose."""
    X = torch.take_along_dim(map_state.X, map_idx.long()[..., None], dim=-2)
    return pnp_refine(cam, X, feats.xy, match_valid, R0, t0,
                      iters=iters, inlier_px=inlier_px)


def _last_writer(idx: torch.Tensor, size: int) -> torch.Tensor:
    """For a scatter of rows to slots ``idx``, the row whose write each of
    ``size`` slots keeps, or -1: the last row, as the JAX CPU reference
    keeps it.  A max over row numbers does not depend on order, so this
    is deterministic on every device."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    init = torch.full((size,), -1, dtype=torch.long, device=idx.device)
    return init.scatter_reduce(0, idx.long(), rows, "amax")


def _scatter_set(dst: torch.Tensor, writer: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].set(src)`` given ``writer = _last_writer(idx, len(dst))``."""
    took = (writer >= 0).view(-1, *([1] * (dst.dim() - 1)))
    return torch.where(took, src[writer.clamp_min(0)], dst)


def _triangulate_and_insert(
    cam: PinholeCamera, map_state: MapState, kf_id: torch.Tensor,
    R_a: torch.Tensor, t_a: torch.Tensor, feats_a: Features,
    R_b: torch.Tensor, t_b: torch.Tensor, feats_b: Features,
    idx_b: torch.Tensor, pair_valid: torch.Tensor,
    already_mapped_a: torch.Tensor, max_new: int,
    min_parallax_cos: float = 0.9998, max_reproj_px: float = 4.0,
    band_lo: float = 0.25, band_hi: float = 4.0, dup_radius_px: float = 48.0,
    local_band: float = 0.0,
):
    """Triangulate descriptor-matched (a, b) feature pairs and insert the
    accepted new landmarks into free map slots.

    idx_b (N,): match of each a-feature in b; pair_valid (N,);
    already_mapped_a (N,): a-features that already track a landmark.  The
    gates (depth, reprojection, parallax, the scene and local depth bands
    against period-aliased matches, the localized duplicate test) are the
    JAX package's; see its comments for why each exists.  Returns
    (new map, number inserted).
    """
    ib = idx_b.long()
    xy_b = feats_b.xy[ib]
    cand = pair_valid & ~already_mapped_a
    X = triangulate(R_a, t_a, cam.normalize(feats_a.xy), R_b, t_b,
                    cam.normalize(xy_b))
    za = depths(R_a, t_a, X)
    zb = depths(R_b, t_b, X)

    def project(P, R, t):
        pc = P @ R.T + t
        z = torch.clamp_min(pc[..., 2], 1e-6)
        return cam.fx * pc[..., 0] / z + cam.cx, cam.fy * pc[..., 1] / z + cam.cy

    def reproj_err(R, t, uv):
        return torch.linalg.norm(torch.stack(project(X, R, t), -1) - uv, dim=-1)

    ea = reproj_err(R_a, t_a, feats_a.xy)
    eb = reproj_err(R_b, t_b, xy_b)
    Ca = -(R_a.T @ t_a)                                # camera centres (world)
    Cb = -(R_b.T @ t_b)
    ra, rb = X - Ca, X - Cb
    cos_par = (ra * rb).sum(-1) / torch.clamp_min(
        torch.linalg.norm(ra, dim=-1) * torch.linalg.norm(rb, dim=-1), 1e-9)
    accept = (cand & (za > 0.05) & (zb > 0.05) & (za < 1e3) & (zb < 1e3)
              & (ea < max_reproj_px) & (eb < max_reproj_px)
              & (cos_par < min_parallax_cos) & torch.isfinite(X).all(-1))

    # Depth band against the median depth of the map points in view.
    nan = torch.full((), float("nan"), device=X.device)
    z_map = depths(R_a, t_a, map_state.X)
    u_m, v_m = project(map_state.X, R_a, t_a)
    in_view = (map_state.valid & (z_map > 0.02)
               & (u_m > 0) & (u_m < 2.0 * cam.cx + 1.0)
               & (v_m > 0) & (v_m < 2.0 * cam.cy + 1.0))
    med_z = nanmedian(torch.where(in_view, z_map, nan))
    have_scene = in_view.sum() >= 30
    band_ok = (za > band_lo * med_z) & (za < band_hi * med_z)
    accept &= torch.where(have_scene & torch.isfinite(med_z), band_ok, True)

    # Duplicates (a similar descriptor projecting near the candidate) and
    # the local depth band (the median depth of map points within 40 px):
    # one kernel on the card (``ops/dupband_cuda.py``).
    dup, z_local, n_neigh = dup_band(feats_a.xy, feats_a.desc, u_m, v_m, z_map,
                                     map_state.desc, map_state.valid, in_view,
                                     dup_radius_px)
    accept &= ~dup
    lb = max(local_band, 1.0)
    local_ok = (za > z_local / lb) & (za < z_local * lb)
    use_local = (n_neigh >= 5) & torch.isfinite(z_local) & (local_band > 1.0)
    accept &= torch.where(use_local, local_ok, True)

    # Accepted candidates by feature score into the first free slots.
    rank_key = torch.where(accept, feats_a.score, torch.full_like(feats_a.score, -1.0))
    order = torch.argsort(-rank_key, stable=True)[:max_new]
    free = torch.argsort(map_state.valid.to(torch.int8), stable=True)[:max_new]
    write = accept[order] & ~map_state.valid[free]

    def put(field, new):
        old = field[free]
        w = write.view(-1, *([1] * (old.dim() - 1)))
        return field.index_copy(0, free, torch.where(w, new, old))

    new_map = MapState(
        X=put(map_state.X, X[order]),
        desc=put(map_state.desc, feats_a.desc[order]),
        valid=put(map_state.valid, True),
        anchor_kf=put(map_state.anchor_kf, kf_id),
        obs_count=put(map_state.obs_count, 1),
        last_seen=put(map_state.last_seen, kf_id),
    )
    return new_map, write.sum(dtype=torch.int32)


def _record_obs(win_obs: torch.Tensor, win_mask: torch.Tensor, slot: torch.Tensor,
                map_idx: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                cam: PinholeCamera | None = None, map_X: torch.Tensor | None = None,
                R: torch.Tensor | None = None, t: torch.Tensor | None = None,
                gate_px: float = 8.0):
    """Record one keyframe's observations into win_obs (K, M, 2) and
    win_mask (K, M) at window slot ``slot`` (0-d tensor).

    With ``map_X`` the observations are gated by reprojection error under
    (R, t): descriptor matching has a wrong-match tail, and wrong
    observations in the BA window drag it off.  Returns (win_obs,
    win_mask, gated valid)."""
    idx = map_idx.long()
    if map_X is not None:
        pc = map_X[idx] @ R.T + t
        z = torch.clamp_min(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        err = torch.linalg.norm(torch.stack([u, v], -1) - uv, dim=-1)
        valid = valid & (pc[..., 2] > 1e-4) & (err < gate_px)
    obs_k = row(win_obs, slot)
    mask_k = row(win_mask, slot)
    writer = _last_writer(idx, obs_k.shape[0])
    obs_k = _scatter_set(obs_k, writer, torch.where(valid[:, None], uv, obs_k[idx]))
    mask_k = _scatter_set(mask_k, writer, valid | mask_k[idx])
    return set_row(win_obs, slot, obs_k), set_row(win_mask, slot, mask_k), valid


def _observe_keyframe(cam: PinholeCamera, cfg: SlamConfig, map_state: MapState,
                      win_obs: torch.Tensor, win_mask: torch.Tensor,
                      slot: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                      kf_id: torch.Tensor, feats: Features):
    """Match a window keyframe's features to the map, guided by its pose
    (R, t) at a wider radius than tracking (re-observing old landmarks
    re-anchors them in the BA window), gate by reprojection, store the
    observations at window slot ``slot`` (0-d tensor), and refresh the
    gated landmarks' descriptors, obs_count and last_seen (``kf_id``).
    Returns (win_obs, win_mask, map)."""
    idx, mvalid = _match_to_map(feats, map_state, cfg.matcher.max_distance,
                                cfg.matcher.ratio, cam=cam, R=R, t=t, radius_px=32.0)
    win_obs, win_mask, gated = _record_obs(win_obs, win_mask, slot, idx, feats.xy,
                                           mvalid, cam=cam, map_X=map_state.X, R=R, t=t)
    ix = idx.long()
    writer = _last_writer(ix, map_state.desc.shape[0])
    return win_obs, win_mask, map_state.replace(
        desc=_scatter_set(map_state.desc, writer,
                          torch.where(gated[:, None], feats.desc, map_state.desc[ix])),
        obs_count=map_state.obs_count.index_add(0, ix, gated.to(torch.int32)),
        last_seen=_scatter_set(map_state.last_seen, writer,
                               torch.where(gated, kf_id, map_state.last_seen[ix])))


def _cull_map(map_state: MapState, kf_id, max_age: int = 10,
              min_obs: int = 2) -> MapState:
    """Invalidate landmarks that stayed single-observation for more than
    ``max_age`` keyframes: they only take capacity and add ambiguity."""
    weak = (map_state.obs_count < min_obs) & (kf_id - map_state.last_seen > max_age)
    return map_state.replace(valid=map_state.valid & ~weak)


def _select(pred: torch.Tensor, a, b):
    """Elementwise ``pred ? a : b`` over matching (nested) tuples/dicts of
    tensors, with a bool ``pred`` that stays on the device: 0-d, or (B,)
    choosing per sequence between tensors with a leading B."""
    if isinstance(a, dict):
        return {k: _select(pred, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_select(pred, x, y) for x, y in zip(a, b))
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim())), a, b)


def _reloc_attempt(cam: PinholeCamera, cfg: SlamConfig, map_state: MapState,
                   feats: Features, R_pred, t_pred, sampler: Sampler, key, guided: bool):
    """One relocalization attempt: match to the map (guided at 64 px around
    the stale pose, or globally), then absolute-pose LO-RANSAC with the
    stale pose as one more hypothesis, its samples drawn under ``key``.
    Returns (idx, match_valid, out)."""
    vo = cfg.vo
    if guided:
        idx, mvalid = _match_to_map(feats, map_state, cfg.matcher.max_distance,
                                    cfg.matcher.ratio, cam=cam, R=R_pred, t=t_pred,
                                    radius_px=64.0)
    else:
        idx, mvalid = _match_to_map(feats, map_state, cfg.matcher.max_distance,
                                    cfg.matcher.ratio)
    sample = sampler.choice(mvalid, (vo.reloc_hypotheses, 6), key=key)
    out = pnp_ransac(cam, map_state.X[idx.long()], feats.xy, mvalid, sample,
                     inlier_px=vo.pnp_inlier_px, refine_iters=vo.pnp_iters,
                     R_prior=R_pred, t_prior=t_pred)
    return idx, mvalid, {k: out[k] for k in ("R", "t", "inliers", "num_inliers", "rmse")}


def _relocalize(cam: PinholeCamera, cfg: SlamConfig, map_state: MapState,
                feats: Features, R_pred, t_pred, sampler: Sampler, key):
    """The staged relocalization of a frame after a lost one: the guided
    attempt first (under self-similar texture a global match is mostly
    aliases), the global one only if that seats fewer than 20 inliers
    (``device_cond``, tally slot ``"reloc_global"``: one sync when run
    eagerly), and the attempt with more inliers wins.  Both draw under
    ``key``."""
    if not cfg.vo.staged_reloc:
        return _reloc_attempt(cam, cfg, map_state, feats, R_pred, t_pred, sampler, key, False)
    res_w = _reloc_attempt(cam, cfg, map_state, feats, R_pred, t_pred, sampler, key, True)

    def fallback():
        res_g = _reloc_attempt(cam, cfg, map_state, feats, R_pred, t_pred, sampler, key, False)
        return _select(res_g[2]["num_inliers"] > res_w[2]["num_inliers"], res_g, res_w)

    return device_cond(res_w[2]["num_inliers"] < 20, fallback, lambda: res_w,
                       names=("reloc_global", None))


class VisualOdometry:
    """The host-stepped monocular tracker with sliding-window BA.

    Bootstrap: the first frame becomes the reference keyframe, and from its
    fourth frame on each frame tries a two-view initialization against it
    (E and H LO-RANSAC, model selection, the parallax gate, scale by the
    median depth); success seeds the map and a two-keyframe window, and
    ``DeviceVO`` takes the state over from there.  Tracking: guided
    matching around the constant-velocity prediction and Gauss-Newton PnP,
    a second pass at 8 px below ``second_pass_below`` inliers, the staged
    relocalization after a lost frame, keyframes with triangulation against
    the newest and the widest-baseline window keyframes, culling and the
    window BA.  Every decision reads the device back, as in the reference;
    ``DeviceVO`` is the tracker that avoids that.

    Arrays live on ``device`` as tensors; the window's occupancy and
    keyframe ids are host numpy, as in the reference.  RANSAC samples come
    from ``sampler`` under the keys ``("two_view", frame_idx, ...)`` and
    ``("host_reloc", frame_idx)``.
    """

    def __init__(self, cfg: SlamConfig, camera: PinholeCamera,
                 bootstrap_depth: float = 2.0, *, device, sampler: Sampler):
        self.cfg = cfg
        self.camera = camera
        self.device = torch.device(device)
        self.frontend = OrbFrontend(cfg.frontend, device=self.device)
        self.two_view = TwoViewEstimator(camera, cfg.matcher, cfg.ransac)
        self.sampler = sampler
        self.bootstrap_depth = bootstrap_depth
        self.reset()

    # ---------------- state ----------------
    def reset(self):
        """Forget the map, window and trajectory (the adaptive FAST
        threshold stays, as the reference's front-end keeps it)."""
        cfg, dev = self.cfg, self.device
        M = cfg.vo.max_map_points
        K = cfg.ba.max_keyframes
        self.map = MapState.empty(M, dev)
        self.win_R, self.win_t = se3_identity((K,), device=dev)
        self.win_obs = torch.zeros((K, M, 2), dtype=torch.float32, device=dev)
        self.win_mask = torch.zeros((K, M), dtype=torch.bool, device=dev)
        self.win_valid = np.zeros(K, bool)
        self.win_kf_id = np.full(K, -1, np.int64)
        self.win_feats: list[Features | None] = [None] * K
        self.kf_feats: Features | None = None
        self.kf_pose = se3_identity(device=dev)
        self.kf0_feats: Features | None = None      # bootstrap reference
        self._kf0_frame = 0
        self.num_keyframes = 0
        self.frame_idx = -1
        self.frames_since_kf = 0
        self.initialized = False
        self.R, self.t = se3_identity(device=dev)
        self.vel = se3_identity(device=dev)
        self.trajectory: list[tuple[np.ndarray, np.ndarray]] = []
        self.stats: list[VOStats] = []
        self.kf_poses_log: list[tuple[int, np.ndarray, np.ndarray]] = []
        self.kf_frames_log: list[int] = []
        self.force_reloc = False

    # ---------------- keyframe window ----------------
    def _push_keyframe(self, R, t, feats: Features, kf_id: int) -> int:
        if self.win_valid.all():                     # roll: drop the oldest
            roll = lambda x: torch.roll(x, -1, 0)   # noqa: E731
            self.win_R, self.win_t = roll(self.win_R), roll(self.win_t)
            self.win_obs, self.win_mask = roll(self.win_obs), roll(self.win_mask)
            self.win_valid = np.roll(self.win_valid, -1)
            self.win_kf_id = np.roll(self.win_kf_id, -1)
            self.win_feats = self.win_feats[1:] + [None]
            slot = len(self.win_valid) - 1
        else:
            slot = int(np.argmin(self.win_valid))   # first free slot
        self.win_R = set_row(self.win_R, slot, R)
        self.win_t = set_row(self.win_t, slot, t)
        self.win_obs = set_row(self.win_obs, slot, 0.0)
        self.win_mask = set_row(self.win_mask, slot, False)
        self.win_valid[slot] = True
        self.win_kf_id[slot] = kf_id
        self.win_feats[slot] = feats
        return slot

    def _record_kf_observations(self, slot: int, feats: Features):
        dev = self.device
        self.win_obs, self.win_mask, self.map = _observe_keyframe(
            self.camera, self.cfg, self.map, self.win_obs, self.win_mask,
            torch.tensor(slot, device=dev), self.win_R[slot], self.win_t[slot],
            torch.tensor(int(self.win_kf_id[slot]), dtype=torch.int32, device=dev), feats)

    def _local_ba(self):
        """Window BA over every map slot (not compacted, unlike the device
        tracker's), points with >= 2 window observations free; skipped
        below three keyframes, so the bootstrap's two run none."""
        cfg = self.cfg.ba
        K = cfg.max_keyframes
        if int(self.win_valid.sum()) < 3:
            return
        dev = self.device
        pose_free = torch.as_tensor(self.win_valid & (np.arange(K) >= 2), device=dev)
        z = self.win_obs.transpose(0, 1)                     # (M, K, 2)
        mask = self.win_mask.T & torch.as_tensor(self.win_valid, device=dev)[None, :]
        multi_obs = mask.sum(1) >= 2
        out = bundle_adjust(
            self.camera, self.win_R, self.win_t, self.map.X, z, mask, pose_free,
            point_valid=self.map.valid & multi_obs, max_iters=cfg.max_iters,
            huber=cfg.huber_delta, lam0=cfg.damping_init, lam_up=cfg.damping_up,
            lam_down=cfg.damping_down)
        self.win_R, self.win_t = out["R"], out["t"]
        self.map = self.map.replace(X=out["X"])
        newest = int(np.nonzero(self.win_valid)[0].max())
        self.R, self.t = self.win_R[newest], self.win_t[newest]
        self.kf_pose = (self.R, self.t)

    # ---------------- bootstrap ----------------
    def _try_bootstrap(self, feats: Features) -> bool:
        res = self.two_view.estimate(self.kf0_feats, feats, self.sampler,
                                     seed=self.frame_idx)
        # One packed readback for the whole attempt.
        n = res["match_valid"].shape[0]
        packed = torch.cat([
            res["R"].reshape(-1), res["t"], res["points"].reshape(-1),
            res["match_valid"].to(torch.float32), res["inliers"].to(torch.float32),
            res["num_inliers"].to(torch.float32).reshape(1)]).cpu().numpy()
        R_np, t_np = packed[:9].reshape(3, 3), packed[9:12]
        X = packed[12:12 + 3 * n].reshape(n, 3)
        match_valid = packed[12 + 3 * n:12 + 4 * n] > 0.5
        inliers = packed[12 + 4 * n:12 + 5 * n] > 0.5
        if int(match_valid.sum()) < 50:
            # Scene overlap with the reference keyframe is gone: re-seed.
            self.kf0_feats = feats
            self._kf0_frame = self.frame_idx
            return False
        if int(packed[-1]) < 60:
            return False
        good = inliers & match_valid & np.isfinite(X).all(axis=-1) \
            & (X[:, 2] > 0.1) & (X[:, 2] < 1e4)
        if good.sum() < 50:
            return False
        med_depth = float(np.median(X[good][:, 2]))
        # Parallax gate: a near-zero baseline triangulates garbage depths.
        C1 = -R_np.T @ t_np                          # second camera centre
        Xg = X[good]
        r1 = Xg - C1
        cosp = np.sum(Xg * r1, -1) / np.maximum(
            np.linalg.norm(Xg, axis=-1) * np.linalg.norm(r1, axis=-1), 1e-12)
        med_par = np.degrees(np.arccos(np.clip(np.median(cosp), -1, 1)))
        if not (med_par >= self.cfg.vo.min_parallax_deg):   # NaN-safe reject
            return False
        scale = self.bootstrap_depth / med_depth
        dev = self.device
        R_rel = torch.from_numpy(R_np.copy()).to(dev)
        t_rel = torch.from_numpy(t_np * scale).to(dev)
        Xs = X * scale

        # World frame := KF0 camera frame.  Insert the map points.
        n_new = min(int(good.sum()), self.cfg.vo.max_map_points)
        sel = torch.from_numpy(np.nonzero(good)[0][:n_new]).to(dev)

        def put(field, new):
            out = field.clone()
            out[:n_new] = new
            return out

        self.map = MapState(
            X=put(self.map.X, torch.from_numpy(Xs).to(dev)[sel]),
            desc=put(self.map.desc, self.kf0_feats.desc[sel]),
            valid=put(self.map.valid, True),
            anchor_kf=put(self.map.anchor_kf, 0),
            obs_count=put(self.map.obs_count, 1),
            last_seen=put(self.map.last_seen, 0))
        # Keyframes: KF0 at identity, the current frame at (R_rel, t_rel).
        R0, t0 = se3_identity(device=dev)
        s0 = self._push_keyframe(R0, t0, self.kf0_feats, kf_id=0)
        self._record_kf_observations(s0, self.kf0_feats)
        s1 = self._push_keyframe(R_rel, t_rel, feats, kf_id=1)
        self._record_kf_observations(s1, feats)
        self.kf_poses_log.append((0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))
        self.kf_poses_log.append((1, R_np, t_np * scale))
        self.kf_frames_log.append(self._kf0_frame)
        self.kf_frames_log.append(self.frame_idx)
        self.num_keyframes = 2
        self.R, self.t = R_rel, t_rel
        self.kf_feats = feats
        self.kf_pose = (R_rel, t_rel)
        self.vel = se3_identity(device=dev)
        self._local_ba()
        self.initialized = True
        self.frames_since_kf = 0
        return True

    # ---------------- keyframe insertion ----------------
    def _best_baseline_slot(self) -> int | None:
        """Window slot whose camera centre lies farthest from the current
        one: back-to-back keyframes have ~zero baseline, and their
        triangulations all fail the parallax gate."""
        valid = np.nonzero(self.win_valid)[0]
        if len(valid) == 0:
            return None
        C_cur = (-self.R.T @ self.t).cpu().numpy()
        C_win = (-torch.einsum("kij,ki->kj", self.win_R, self.win_t)).cpu().numpy()
        best, best_d = None, -1.0
        for s in valid:
            if self.win_feats[s] is None:
                continue
            d = float(np.linalg.norm(C_win[s] - C_cur))
            if d > best_d:
                best, best_d = int(s), d
        return best

    def _insert_keyframe(self, feats: Features, match_valid, inliers) -> int:
        """Make the current frame keyframe ``num_keyframes``: triangulate
        against the newest and the widest-baseline window keyframes (the
        first matches best, the second triangulates best), re-record each
        partner's observations, push the frame into the window, record its
        own, cull weak landmarks and run the window BA.  Returns the number
        of landmarks inserted."""
        dev = self.device
        kf_id = self.num_keyframes
        self.num_keyframes += 1
        kf = torch.tensor(kf_id, dtype=torch.int32, device=dev)
        already = match_valid & inliers
        newest = int(np.nonzero(self.win_valid)[0].max()) if self.win_valid.any() else None
        refs = []
        for r in (newest, self._best_baseline_slot()):
            if r is not None and r not in refs and self.win_feats[r] is not None:
                refs.append(r)
        n_new = 0
        for ref in refs:
            ref_feats = self.win_feats[ref]
            m = match_descriptors(feats.desc, feats.valid, ref_feats.desc, ref_feats.valid,
                                  max_distance=self.cfg.matcher.max_distance,
                                  ratio=self.cfg.matcher.ratio, cross_check=True)
            self.map, n_ins = _triangulate_and_insert(
                self.camera, self.map, kf, self.R, self.t, feats,
                self.win_R[ref], self.win_t[ref], ref_feats, m["idx_b"], m["valid"],
                already, max_new=self.cfg.frontend.features_per_level,
                band_lo=self.cfg.vo.tri_band_lo, band_hi=self.cfg.vo.tri_band_hi,
                dup_radius_px=self.cfg.vo.dup_radius_px,
                local_band=self.cfg.vo.tri_local_band)
            n_new += int(n_ins)
            # Second-view registration of the landmarks just triangulated.
            self._record_kf_observations(ref, ref_feats)
        slot = self._push_keyframe(self.R, self.t, feats, kf_id)
        self._record_kf_observations(slot, feats)
        self.kf_feats = feats
        self.kf_pose = (self.R, self.t)
        self.kf_poses_log.append((kf_id, self.R.cpu().numpy(), self.t.cpu().numpy()))
        self.kf_frames_log.append(self.frame_idx)
        self.map = _cull_map(self.map, kf)
        self._local_ba()
        self.frames_since_kf = 0
        return n_new

    # ---------------- per-frame ----------------
    def process(self, image) -> VOStats:
        """One frame ((H, W) numpy array or tensor, uint8 or float in
        [0, 1]): a bootstrap attempt until the map exists, tracking after."""
        self.frame_idx += 1
        image = torch.as_tensor(image).to(self.device)
        feats = self.frontend.extract(image)
        n_feat, n_lm = torch.stack([feats.count.to(torch.int64),
                                    self.map.valid.sum()]).tolist()
        st = VOStats(frame=self.frame_idx, num_features=n_feat, num_landmarks=n_lm)
        if not self.initialized:
            if self.kf0_feats is None:
                self.kf0_feats = feats
                self._kf0_frame = self.frame_idx
                st.is_keyframe = True
            else:
                # The first two frames after the seed have near-zero baseline
                # and always fail the parallax gate: skip only those.
                age = self.frame_idx - self._kf0_frame
                if age >= 3 and self._try_bootstrap(feats):
                    st.tracking = True
                    st.is_keyframe = True
                    st.num_landmarks = int(self.map.valid.sum())
        else:
            self._track(feats, st)
        self.trajectory.append((self.R.cpu().numpy(), self.t.cpu().numpy()))
        self.stats.append(st)
        return st

    def _track(self, feats: Features, st: VOStats) -> None:
        cfg, vo = self.cfg, self.cfg.vo
        R_pred, t_pred = se3_compose(*self.vel, self.R, self.t)
        relocalizing = self.force_reloc or (bool(self.stats) and not self.stats[-1].tracking)
        self.force_reloc = False
        if relocalizing:
            # A local Gauss-Newton from a stale pose cannot recover.
            idx, mvalid, out = _relocalize(self.camera, cfg, self.map, feats, R_pred, t_pred,
                                           self.sampler, ("host_reloc", self.frame_idx))
        else:
            idx, mvalid = _match_to_map(feats, self.map, cfg.matcher.max_distance,
                                        cfg.matcher.ratio, cam=self.camera, R=R_pred,
                                        t=t_pred, radius_px=vo.track_radius_px)
            out = _track_pnp(self.camera, feats, self.map, idx, mvalid, R_pred, t_pred,
                             iters=vo.pnp_iters, inlier_px=vo.pnp_inlier_px)
        st.num_matches = int(mvalid.sum())
        if vo.track_two_pass and 15 <= int(out["num_inliers"]) < vo.second_pass_below:
            # Re-match under a tight radius around the refined pose.
            idx2, mvalid2 = _match_to_map(feats, self.map, cfg.matcher.max_distance,
                                          cfg.matcher.ratio, cam=self.camera, R=out["R"],
                                          t=out["t"], radius_px=8.0)
            if int(mvalid2.sum()) >= st.num_matches:
                out2 = _track_pnp(self.camera, feats, self.map, idx2, mvalid2, out["R"],
                                  out["t"], iters=vo.pnp_iters, inlier_px=vo.pnp_inlier_px)
                if int(out2["num_inliers"]) >= int(out["num_inliers"]):
                    idx, mvalid, out = idx2, mvalid2, out2
        finite = torch.isfinite(out["R"]).all() & torch.isfinite(out["t"]).all()
        n_in, rmse, pose_finite = torch.stack([
            out["num_inliers"].to(torch.float32), out["rmse"], finite.to(torch.float32)]).tolist()
        n_in = int(n_in)
        st.num_inliers, st.rmse_px = n_in, rmse
        if n_in >= 20 and pose_finite and rmse < 3.0 * vo.pnp_inlier_px:
            R_prev, t_prev = self.R, self.t
            self.R, self.t = out["R"], out["t"]
            if relocalizing:
                # The previous pose was stale: its velocity would be bogus.
                self.vel = se3_identity(device=self.device)
            else:
                # Low-passed constant-velocity model.
                Rv, tv = se3_compose(self.R, self.t, *se3_inverse(R_prev, t_prev))
                self.vel = se3_exp(0.6 * se3_log(Rv, tv) + 0.4 * se3_log(*self.vel))
            st.tracking = True
        else:
            # Lost: hold the last pose and reset the motion model.
            self.vel = se3_identity(device=self.device)
        self.frames_since_kf += 1
        need_kf = st.tracking and (
            self.frames_since_kf >= vo.keyframe_max_interval
            or (n_in < vo.keyframe_min_inliers
                and self.frames_since_kf >= vo.keyframe_min_interval)
            or n_in < vo.keyframe_critical_inliers)
        if need_kf:
            self._insert_keyframe(feats, mvalid, out["inliers"])
            st.is_keyframe = True
            st.num_landmarks = int(self.map.valid.sum())

    def run(self, images) -> list[VOStats]:
        return [self.process(im) for im in images]

    @property
    def positions(self) -> np.ndarray:
        """Camera centres (world frame) of the trajectory."""
        return np.asarray([-R.T @ t for R, t in self.trajectory])
