"""Device-resident visual odometry: tracking, relocalization, keyframe
insertion and windowed bundle adjustment, and the host shell that
bootstraps it (mirrors ``tinyslam_tpu/models/vo_device.py: VOState,
track_step, track_chunk, DeviceVO`` and its keyframe helpers).

The JAX package compiles all per-frame control flow into ``lax.cond`` and
runs a chunk of frames as one ``lax.scan``.  Here each of its ``lax.cond``s
is a ``device_cond`` (``utils/cuda_graph.py``): whether the last frame
tracked, on a relocalization frame whether the guided attempt seated 20
inliers (``models/vo.py:_relocalize``), whether the second PnP pass runs,
whether the frame becomes a keyframe, and on a keyframe whether the window
holds the three keyframes BA needs.  ``track_step`` itself reads nothing
back to decide anything else (pose update, velocity model, adaptive
threshold, window roll, slot choice, RANSAC draws and votes, BA accepts,
the summary row stay on the device; no 0-d index tensor is read back:
``row``/``set_row``), and the relocalization's draws are keyed by the
frame number on the device (``utils/draws.py``).

On the card ``DeviceVO`` tracks a chunk as replays of one captured CUDA
graph of ``track_step`` (``ChunkGraph``), in which every ``device_cond`` is
a conditional node: only the branch a frame takes runs, as on the TPU, no
replay synchronizes, and the host reads the chunk back once (its tracking
flags, to count lost frames, with the graph's branch tally).  Called
eagerly, ``track_step`` and ``track_chunk`` are the plain version: each
``device_cond`` reads its predicate, so a frame synchronizes three times,
a keyframe four, a relocalization frame one more; the CPU runs them, and
the card's comparisons run them beside the graph, with equal results.

Before the first state exists, ``DeviceVO`` runs the host-stepped
bootstrap of ``models/vo.py:VisualOdometry`` frame by frame and lifts its
result into a ``VOState``; after ``reloc_max_frames`` lost frames it drops
the state and bootstraps a fresh submap anchored at the last pose.

``track_step_batch`` / ``track_chunk_batch`` track B independent sequences
(a ``VOState`` with a leading B, ``VOState.stack``) as one program, the
counterpart of the JAX package's ``vmap(track_chunk)``: the common path
batched over the B rows, the rare branches ``device_cond``s (a
relocalization and a keyframe insertion per row, on its row; the second
pass one masked batched body), so that a step reads nothing back.  On the
card a chunk of B streams runs as replays of one captured step
(``BatchGraph``), one replay a step.  Neither graph is keyed by a seed:
the keyed draws read the samplers' seeds from a static buffer
(``Sampler.keyed_on``), so one graph serves every seed.

Each chunk of either graph, and of ``track_chunk_batch``'s plain path,
leaves a record of its host times and, on the card, of its replays'
spans and its bodies' nanoseconds (``utils/spans.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tinyslam_tpu_torch.backend.ba import bundle_adjust
from tinyslam_tpu_torch.config import SlamConfig
from tinyslam_tpu_torch.frontend.orb import adapt_threshold, extract_batch, extract_features
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.geometry.se3 import (
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
)
from tinyslam_tpu_torch.models.vo import (
    MapState,
    VisualOdometry,
    VOStats,
    _cull_map,
    _match_to_map,
    _observe_keyframe,
    _relocalize,
    _select,
    _track_pnp,
    _triangulate_and_insert,
)
from tinyslam_tpu_torch.ops.hamming import match_descriptors
from tinyslam_tpu_torch.types import Features, from_numpy, row, set_row, to_numpy
from tinyslam_tpu_torch.utils import spans
from tinyslam_tpu_torch.utils.cuda_graph import (
    CAPTURE_LOCK,
    add_launches,
    capture,
    counters_kept,
    device_cond,
    device_span,
    tree_leaves,
    warm_checked,
)
from tinyslam_tpu_torch.utils.draws import Sampler, seed_word

# Ring of per-keyframe features, slot kf_id % KF_RING; it must cover the
# keyframes of one chunk (at most one a frame), so chunk <= KF_RING.
KF_RING = 32

_FEATURE_FIELDS = tuple(f.name for f in dataclasses.fields(Features))
_TENSOR_FIELDS = ("win_R", "win_t", "win_obs", "win_mask", "win_valid",
                  "win_kf_id", "R", "t", "vel_R", "vel_t", "num_keyframes",
                  "frames_since_kf", "frame_idx", "last_tracking", "threshold")


def _tree_map(fn, *trees):
    """``fn`` over the tensors of dataclasses of one structure (a
    ``VOState`` with its nested map and features, or one of those)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return type(first)(**{f.name: _tree_map(fn, *(getattr(t, f.name) for t in trees))
                          for f in dataclasses.fields(first)})


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
        feature, in slot order), as the JAX package's ``entry()`` seeds its
        map directly: a tracking state without the two-view bootstrap."""
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

    # A batch of B sequences is one VOState whose every tensor (the map,
    # window features and keyframe ring included) has a leading B, as the
    # JAX package's vmapped state has.
    @staticmethod
    def stack(states: list["VOState"]) -> "VOState":
        """B states of one config on one device -> the batched state."""
        return _tree_map(lambda *xs: torch.stack(xs), *states)

    def unstack(self) -> list["VOState"]:
        """The batched state's B sequences, as views."""
        return [self.row(b) for b in range(self.R.shape[0])]

    def row(self, b: int) -> "VOState":
        """Sequence ``b`` (a host int) of the batched state, as views (the
        batched step's keyframe bodies write a row through them)."""
        return _tree_map(lambda x: x[b], self)


# The pose result of a tracking or relocalization branch.
_POSE_FIELDS = ("R", "t", "inliers", "num_inliers", "rmse")

# Packed per-frame summary layout (float32).
SUMMARY_FIELDS = (
    "num_features", "num_matches", "num_inliers", "tracking",
    "is_keyframe", "num_landmarks", "rmse_px", "threshold",
)


def _newest_slot(win_kf_id: torch.Tensor) -> torch.Tensor:
    return torch.argmax(win_kf_id)


def _record_kf_obs(cam: PinholeCamera, cfg: SlamConfig, state: VOState,
                   slot: torch.Tensor, feats: Features) -> VOState:
    """``_observe_keyframe`` for window slot ``slot`` at its pose."""
    win_obs, win_mask, m = _observe_keyframe(
        cam, cfg, state.map, state.win_obs, state.win_mask, slot,
        row(state.win_R, slot), row(state.win_t, slot), row(state.win_kf_id, slot), feats)
    return state.replace(win_obs=win_obs, win_mask=win_mask, map=m)


def _push_keyframe(state: VOState, R, t, feats: Features,
                   kf_id) -> tuple[VOState, torch.Tensor]:
    """Put a keyframe into the window: roll every window array when the
    window is full (slot order = age) and write the last slot, else write
    the first free slot.  Returns the state and the slot."""
    K = state.win_valid.shape[0]
    full = state.win_valid.all()

    def rolled(x):
        return torch.where(full, torch.roll(x, -1, 0), x)

    win_valid = rolled(state.win_valid)
    slot = torch.where(full, torch.full_like(kf_id, K - 1, dtype=torch.long),
                       torch.argmin(win_valid.to(torch.int32)))
    return state.replace(
        win_R=set_row(rolled(state.win_R), slot, R),
        win_t=set_row(rolled(state.win_t), slot, t),
        win_obs=set_row(rolled(state.win_obs), slot, 0.0),
        win_mask=set_row(rolled(state.win_mask), slot, False),
        win_valid=set_row(win_valid, slot, True),
        win_kf_id=set_row(rolled(state.win_kf_id), slot, kf_id),
        win_feats=Features(**{
            f: set_row(rolled(getattr(state.win_feats, f)), slot, getattr(feats, f))
            for f in _FEATURE_FIELDS}),
    ), slot


def _local_ba(cam: PinholeCamera, cfg: SlamConfig, state: VOState) -> VOState:
    """Windowed BA over the ``cfg.ba.max_landmarks`` window landmarks with
    the most observations (ties to the lowest slot, as ``lax.top_k``); the
    first two window slots fix the gauge.  Updated points scatter back;
    the current pose becomes the newest keyframe's."""
    K = cfg.ba.max_keyframes
    C = min(cfg.ba.max_landmarks, cfg.vo.max_map_points)
    dev = state.device
    pose_free = state.win_valid & (torch.arange(K, device=dev) >= 2)
    z = state.win_obs.transpose(0, 1)                   # (M, K, 2)
    mask = state.win_mask.T & state.win_valid[None, :]
    obs_cnt = mask.sum(1, dtype=torch.int32)
    score = torch.where(state.map.valid & (obs_cnt >= 2), obs_cnt,
                        torch.full_like(obs_cnt, -1))
    sel = torch.sort(score, descending=True, stable=True).indices[:C]
    sel_ok = score[sel] > 0
    X_sel = state.map.X[sel]
    out = bundle_adjust(
        cam, state.win_R, state.win_t, X_sel, z[sel], mask[sel], pose_free,
        point_valid=sel_ok, max_iters=cfg.ba.max_iters, huber=cfg.ba.huber_delta,
        lam0=cfg.ba.damping_init, lam_up=cfg.ba.damping_up,
        lam_down=cfg.ba.damping_down)
    X_new = state.map.X.index_copy(
        0, sel, torch.where(sel_ok[:, None], out["X"], X_sel))
    newest = _newest_slot(state.win_kf_id)
    return state.replace(
        win_R=out["R"], win_t=out["t"], map=state.map.replace(X=X_new),
        R=row(out["R"], newest), t=row(out["t"], newest))


def _cull_landmarks(state: VOState, kf_id) -> VOState:
    return state.replace(map=_cull_map(state.map, kf_id))


def _best_baseline_slot(state: VOState) -> torch.Tensor:
    """Window slot whose camera centre lies farthest from the current one:
    back-to-back keyframes triangulate nothing."""
    C_cur = -(state.R.T @ state.t)
    C_win = -torch.einsum("kij,ki->kj", state.win_R, state.win_t)  # (K, 3)
    d = torch.linalg.norm(C_win - C_cur, dim=-1)
    return torch.argmax(torch.where(state.win_valid, d, torch.full_like(d, -1.0)))


def _insert_keyframe(cam: PinholeCamera, cfg: SlamConfig, state: VOState,
                     feats: Features, match_valid, inliers) -> VOState:
    """Make the current frame a keyframe: triangulate new landmarks against
    the newest and the widest-baseline window keyframes (the first matches
    best, the second triangulates best; the gates keep what is well
    conditioned), push it into the window, record its observations, cull
    weak landmarks, and run the windowed BA once three keyframes exist."""
    kf_id = state.num_keyframes
    already = match_valid & inliers
    for ref in (_newest_slot(state.win_kf_id), _best_baseline_slot(state)):
        ref_feats = state.win_feats.map(lambda x: row(x, ref))
        m = match_descriptors(
            feats.desc, feats.valid, ref_feats.desc, ref_feats.valid,
            max_distance=cfg.matcher.max_distance, ratio=cfg.matcher.ratio,
            cross_check=True)
        with device_span("tri"):
            new_map, _ = _triangulate_and_insert(
                cam, state.map, kf_id, state.R, state.t, feats,
                row(state.win_R, ref), row(state.win_t, ref), ref_feats,
                m["idx_b"], m["valid"], already,
                max_new=cfg.frontend.features_per_level,
                band_lo=cfg.vo.tri_band_lo, band_hi=cfg.vo.tri_band_hi,
                dup_radius_px=cfg.vo.dup_radius_px, local_band=cfg.vo.tri_local_band)
        state = state.replace(map=new_map)
        # Second-view registration of the landmarks just triangulated.
        state = _record_kf_obs(cam, cfg, state, ref, ref_feats)
    state, slot = _push_keyframe(state, state.R, state.t, feats, kf_id)
    state = _record_kf_obs(cam, cfg, state, slot, feats)
    ring_slot = torch.remainder(kf_id, KF_RING)
    state = state.replace(
        num_keyframes=kf_id + 1,
        frames_since_kf=torch.zeros_like(state.frames_since_kf),
        kf_ring=Features(**{
            f: set_row(getattr(state.kf_ring, f), ring_slot, getattr(feats, f))
            for f in _FEATURE_FIELDS}))
    state = _cull_landmarks(state, kf_id)
    return device_cond(state.win_valid.sum() >= 3, lambda s: _local_ba(cam, cfg, s),
                       lambda s: s, (state,), names=("ba", None))


def track_step(cam: PinholeCamera, cfg: SlamConfig, state: VOState,
               image: torch.Tensor, sampler: Sampler) -> tuple[VOState, dict]:
    """One tracked frame: relocalization where the last frame was lost, a
    keyframe where the policy asks for one.  Mirrors the JAX
    ``track_step`` decision for decision.

    ``image`` (H, W) is float in [0, 1] or uint8, on the state's device.
    ``sampler`` draws the relocalization's RANSAC samples.  Returns the new state and {"R", "t",
    "summary"} (summary as in ``SUMMARY_FIELDS``; ``num_landmarks`` counts
    after insertion and culling).
    """
    if image.dtype == torch.uint8:
        image = image.to(torch.float32) * (1.0 / 255.0)
    vo = cfg.vo
    feats = extract_features(image, state.threshold, cfg.frontend)
    threshold = state.threshold
    if cfg.frontend.adaptive_threshold:
        threshold = adapt_threshold(threshold, feats.count, feats.capacity,
                                    cfg.frontend.target_fill)

    R_pred, t_pred = se3_compose(state.vel_R, state.vel_t, state.R, state.t)

    def track_branch():
        idx, mvalid = _match_to_map(
            feats, state.map, cfg.matcher.max_distance, cfg.matcher.ratio,
            cam=cam, R=R_pred, t=t_pred, radius_px=vo.track_radius_px)
        out = _track_pnp(cam, feats, state.map, idx, mvalid, R_pred, t_pred,
                         iters=vo.pnp_iters, inlier_px=vo.pnp_inlier_px)
        return idx, mvalid, {k: out[k] for k in _POSE_FIELDS}

    def reloc_branch():
        # Lost last frame: a local Gauss-Newton from a stale pose cannot
        # recover, so absolute-pose RANSAC.
        return _relocalize(cam, cfg, state.map, feats, R_pred, t_pred, sampler,
                           ("reloc", state.frame_idx))

    idx, mvalid, out = device_cond(state.last_tracking, track_branch, reloc_branch,
                                   names=("track", "reloc"))

    if vo.track_two_pass:
        def second_pass(idx, mvalid, out):
            idx2, mvalid2 = _match_to_map(
                feats, state.map, cfg.matcher.max_distance, cfg.matcher.ratio,
                cam=cam, R=out["R"], t=out["t"], radius_px=8.0)
            out2 = _track_pnp(cam, feats, state.map, idx2, mvalid2,
                              out["R"], out["t"], iters=vo.pnp_iters,
                              inlier_px=vo.pnp_inlier_px)
            better = (mvalid2.sum() >= mvalid.sum()) & (
                out2["num_inliers"] >= out["num_inliers"])
            return _select(better, (idx2, mvalid2, {k: out2[k] for k in _POSE_FIELDS}),
                           (idx, mvalid, out))

        n1 = out["num_inliers"]
        idx, mvalid, out = device_cond((n1 >= 15) & (n1 < vo.second_pass_below), second_pass,
                                       lambda *a: a, (idx, mvalid, out),
                                       names=("second_pass", None))

    n_in = out["num_inliers"]
    pose_finite = torch.isfinite(out["R"]).all() & torch.isfinite(out["t"]).all()
    tracking = (n_in >= 20) & pose_finite & (out["rmse"] < 3.0 * vo.pnp_inlier_px)

    # Accept: update the pose and the low-passed constant-velocity model.
    # After a relocalization the previous pose was stale, so the velocity
    # resets instead.
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
    new_state = device_cond(
        need_kf, lambda st: _insert_keyframe(cam, cfg, st, feats, mvalid, out["inliers"]),
        lambda st: st, (new_state,), names=("keyframe", None))

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
                images: torch.Tensor, active, sampler: Sampler) -> tuple[VOState, dict]:
    """Track a (B, H, W) chunk of frames.

    ``active`` (B,) bool (host list or tensor) masks padding frames at the
    tail of a sequence: an inactive step leaves the state as it is and
    records a zero summary.  ``sampler`` as in ``track_step``.  Returns the
    final state and {"R" (B, 3, 3), "t" (B, 3), "summary" (B,
    len(SUMMARY_FIELDS))}.
    """
    active = torch.as_tensor(active).tolist()
    Rs, ts, summaries = [], [], []
    for image, act in zip(images, active):
        if act:
            state, ys = track_step(cam, cfg, state, image, sampler)
        else:
            ys = {"R": state.R, "t": state.t,
                  "summary": torch.zeros(len(SUMMARY_FIELDS), dtype=torch.float32,
                                         device=state.device)}
        Rs.append(ys["R"])
        ts.append(ys["t"])
        summaries.append(ys["summary"])
    return state, {"R": torch.stack(Rs), "t": torch.stack(ts),
                   "summary": torch.stack(summaries)}


# The branch bodies the graph's tally counts (``device_cond`` names).
BRANCHES = ("track", "reloc", "reloc_global", "second_pass", "keyframe", "ba")


class _StepGraph:
    """What ``ChunkGraph`` and ``BatchGraph`` share: a captured step over a
    static state (``static``), its branch tally (``captured.tally``, one
    slot a name of ``captured.names``) and the launch accounting of its
    bodies."""

    def _hold(self, captured) -> None:
        self.captured = captured
        self.summary = captured.outputs
        self.tally = captured.tally
        self._accounted = [0] * len(captured.names)
        self.replays = 0

    def _load(self, state: VOState) -> None:
        """Copy ``state`` into the static state buffers."""
        for dst, src in zip(tree_leaves(self.static), tree_leaves(state)):
            if src is not dst:
                if src.shape != dst.shape or src.dtype != dst.dtype or src.device != dst.device:
                    raise ValueError(f"{type(self).__name__}: the state does not fit the "
                                     f"captured one")
                dst.copy_(src)

    def account(self, tally) -> dict[str, int]:
        """Add the launches of the branch bodies run since the last call
        to the kernels' counters, from ``tally`` as read back (a sequence
        of numbers, one a name of the graph's branches).  Returns those
        runs (a batched graph's summed over rows)."""
        runs = {name: int(v) - a
                for name, v, a in zip(self.captured.names, tally, self._accounted)}
        self._accounted = [int(v) for v in tally]
        for name, k in runs.items():
            per = self.captured.body_launches.get(name, (0,) * len(self.captured.base))
            add_launches([k * x for x in per])
        return runs


class ChunkGraph(_StepGraph):
    """``track_chunk`` on the card as replays of one captured
    ``track_step``, the counterpart of the JAX package's jitted
    ``lax.scan`` of ``lax.cond``s: each ``device_cond`` of the step (the
    tracking or relocalization branch, the relocalization's global
    fallback, the second PnP pass, the keyframe insertion and its window
    BA) is a conditional node, and a replay runs only the branches its
    frame takes.  Nothing in ``track_chunk`` reads the device back.

    Built by ``chunk_graph`` for one camera, config, image shape and dtype,
    device and sampler type, never for a seed: the keyed draws read the
    sampler's seed from a static buffer (``draw_as``).  It first runs the
    step with every branch taken (``utils.cuda_graph.warm``) on a copy of
    the state, twice, the second time with any synchronization an error (a
    step that reads the device back cannot be captured), then captures it
    over static buffers: the state, which the graph's last nodes overwrite
    with the new state, the image and the seed.  A failed capture raises.

    Each replay adds the launches of the graph outside its branches to
    the kernels' counters at once (``cuda_graph.add_launches``); ``tally``
    (int32, one slot a name of ``BRANCHES``, cumulative) counts on the
    device the branch bodies that ran, and ``account`` adds their launches
    once the caller has read it back with whatever else it reads.
    """

    def __init__(self, cam: PinholeCamera, cfg: SlamConfig, state: VOState,
                 image: torch.Tensor, sampler: Sampler):
        dev = state.device
        if dev.type != "cuda":
            raise ValueError(f"ChunkGraph: a state on {dev}; the graph runs on the card")
        self.static = _tree_map(torch.clone, state)
        self.image = image.clone()
        self.seed = torch.full((), seed_word(sampler), dtype=torch.int64, device=dev)
        keyed = sampler.keyed_on(self.seed)

        def step():
            new, ys = track_step(cam, cfg, self.static, self.image, keyed)
            for dst, src in zip(tree_leaves(self.static), tree_leaves(new)):
                if src is not dst:
                    dst.copy_(src)
            return ys["summary"]

        def warm_step():
            track_step(cam, cfg, _tree_map(torch.clone, state), self.image, keyed)

        with CAPTURE_LOCK, counters_kept():
            warm_checked(warm_step, dev, BRANCHES)
            self._hold(capture(step, dev, BRANCHES))

    def draw_as(self, sampler: Sampler) -> None:
        """Make the replays draw as ``sampler`` does: its seed into the
        seed buffer, without blocking."""
        self.seed.fill_(seed_word(sampler))

    def track_chunk(self, state: VOState, images: torch.Tensor, active
                    ) -> tuple[VOState, dict]:
        """``track_chunk``'s result for a (B, H, W) chunk on the card, with
        no host sync: per active frame one image copy, one replay and the
        copies of its pose and summary.  An inactive frame is not replayed
        and records a zero summary.  The returned state is a copy of the
        static one."""
        if images.shape[1:] != self.image.shape or images.dtype != self.image.dtype:
            raise ValueError(f"ChunkGraph: images {tuple(images.shape)} {images.dtype} for "
                             f"a graph of {tuple(self.image.shape)} {self.image.dtype}")
        rec = spans.Chunk("chunk", images.shape[0])
        active = torch.as_tensor(active).tolist()
        self._load(state)
        rec.loaded()
        B, dev = images.shape[0], self.image.device
        Rs = torch.empty((B, 3, 3), dtype=torch.float32, device=dev)
        ts = torch.empty((B, 3), dtype=torch.float32, device=dev)
        summaries = torch.zeros((B, len(SUMMARY_FIELDS)), dtype=torch.float32, device=dev)
        n = 0
        for c in range(B):
            if active[c]:
                self.image.copy_(images[c])
                self.captured.graph.replay()
                summaries[c].copy_(self.summary)
                n += 1
            Rs[c].copy_(self.static.R)
            ts[c].copy_(self.static.t)
        rec.launched()
        self.replays += n
        add_launches([n * k for k in self.captured.base])
        out = _tree_map(torch.clone, self.static)
        rec.close(self.captured, n)
        return out, {"R": Rs, "t": ts, "summary": summaries}

_GRAPHS: dict = {}


def chunk_graph(cam: PinholeCamera, cfg: SlamConfig, state: VOState, image: torch.Tensor,
                sampler: Sampler) -> ChunkGraph:
    """The ``ChunkGraph`` of this camera, config, image shape and dtype,
    device and sampler type, captured at first use and kept for the
    process (graphs hold no state between chunks: each chunk loads its
    own), set to draw as ``sampler`` (``ChunkGraph.draw_as``): one graph
    serves every seed."""
    key = (cam, cfg, tuple(image.shape), image.dtype, state.device, type(sampler))
    if key not in _GRAPHS:
        _GRAPHS[key] = ChunkGraph(cam, cfg, state, image, sampler)
    graph = _GRAPHS[key]
    graph.draw_as(sampler)
    return graph


def _track_rows(cam: PinholeCamera, cfg: SlamConfig, feats: Features, map_state: MapState,
                R0, t0, radius_px: float) -> dict:
    """Guided matching and PnP of every sequence of the batch from its pose
    (R0, t0): one K2 launch and one batched ``pnp_refine``.  Returns
    {"idx", "mvalid", "R", "t", "inliers", "num_inliers", "rmse"}, each
    with a leading B."""
    idx, mvalid = _match_to_map(feats, map_state, cfg.matcher.max_distance, cfg.matcher.ratio,
                                cam=cam, R=R0, t=t0, radius_px=radius_px, span="k2.track")
    out = _track_pnp(cam, feats, map_state, idx, mvalid, R0, t0, iters=cfg.vo.pnp_iters,
                     inlier_px=cfg.vo.pnp_inlier_px)
    return {"idx": idx, "mvalid": mvalid, **{k: out[k] for k in _POSE_FIELDS}}


def _by_row(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` where the (B,) ``mask`` holds, else ``old``, row by row."""
    return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), new, old)


def _step_batch(cam: PinholeCamera, cfg: SlamConfig, states: VOState, images: torch.Tensor,
                active: torch.Tensor, samplers: list) -> tuple[VOState, dict]:
    """``track_step_batch`` on a batched state handed over to it: the
    keyframe bodies write their rows of its map, window, keyframe ring and
    keyframe count in place.  ``active`` is a (B,) bool tensor on the
    state's device.  Reads nothing back outside ``device_cond``."""
    B = states.R.shape[0]
    dev = states.device
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) * (1.0 / 255.0)
    vo = cfg.vo
    feats = extract_batch(images, states.threshold, cfg.frontend)
    threshold = states.threshold
    if cfg.frontend.adaptive_threshold:
        threshold = adapt_threshold(threshold, feats.count, feats.capacity,
                                    cfg.frontend.target_fill)
    R_pred, t_pred = se3_compose(states.vel_R, states.vel_t, states.R, states.t)

    # The guided pass over every row (one K2 launch, one batched PnP); a row
    # that lost its last frame overwrites its own with its relocalization.
    res = _track_rows(cam, cfg, feats, states.map, R_pred, t_pred, vo.track_radius_px)
    lost = active & ~states.last_tracking

    def relocalize(b: int):
        idx, mvalid, out = _relocalize(
            cam, cfg, _tree_map(lambda x: x[b], states.map), feats.map(lambda x: x[b]),
            R_pred[b], t_pred[b], samplers[b], ("reloc", states.frame_idx[b]))
        for k, v in {"idx": idx, "mvalid": mvalid, **out}.items():
            res[k][b] = v
        return ()

    for b in range(B):
        device_cond(lost[b], relocalize, lambda b: (), (b,), names=("reloc", None))

    if vo.track_two_pass:
        n1 = res["num_inliers"]
        again = active & (n1 >= 15) & (n1 < vo.second_pass_below)

        def second_pass(cur):
            # Every row's second pass, one K2 launch; a row keeps it where it
            # asked for it and found it better.
            new = _track_rows(cam, cfg, feats, states.map, cur["R"], cur["t"], 8.0)
            better = (new["mvalid"].sum(-1) >= cur["mvalid"].sum(-1)) & (
                new["num_inliers"] >= cur["num_inliers"])
            return _select(again & better, new, cur)

        res = device_cond(again.any(), second_pass, lambda cur: cur, (res,),
                          names=("second_pass", None))

    n_in = res["num_inliers"]
    pose_finite = torch.isfinite(res["R"]).all((-2, -1)) & torch.isfinite(res["t"]).all(-1)
    tracking = (n_in >= 20) & pose_finite & (res["rmse"] < 3.0 * vo.pnp_inlier_px)
    Ri, ti = se3_inverse(states.R, states.t)
    Rv_new, tv_new = se3_compose(res["R"], res["t"], Ri, ti)
    xi = 0.6 * se3_log(Rv_new, tv_new) + 0.4 * se3_log(states.vel_R, states.vel_t)
    vel_R_acc, vel_t_acc = se3_exp(xi)
    vel_id_R, vel_id_t = se3_identity(device=dev)
    use_vel = tracking & states.last_tracking
    frames_since_kf = states.frames_since_kf + 1
    # An inactive row keeps its state.
    new_states = states.replace(
        R=_by_row(active & tracking, res["R"], states.R),
        t=_by_row(active & tracking, res["t"], states.t),
        vel_R=_by_row(active, _by_row(use_vel, vel_R_acc, vel_id_R), states.vel_R),
        vel_t=_by_row(active, _by_row(use_vel, vel_t_acc, vel_id_t), states.vel_t),
        last_tracking=_by_row(active, tracking, states.last_tracking),
        frames_since_kf=_by_row(active, frames_since_kf, states.frames_since_kf),
        frame_idx=_by_row(active, states.frame_idx + 1, states.frame_idx),
        threshold=_by_row(active, threshold, states.threshold),
    )
    need_kf = tracking & (
        (frames_since_kf >= vo.keyframe_max_interval)
        | ((n_in < vo.keyframe_min_inliers)
           & (frames_since_kf >= vo.keyframe_min_interval))
        | (n_in < vo.keyframe_critical_inliers))

    def keyframe(b: int):
        # Sequence b's keyframe and window BA, written into its row in place.
        row = new_states.row(b)
        new = _insert_keyframe(cam, cfg, row, feats.map(lambda x: x[b]), res["mvalid"][b],
                               res["inliers"][b])
        for dst, src in zip(tree_leaves(row), tree_leaves(new)):
            if src is not dst:
                dst.copy_(src)
        return ()

    insert = active & need_kf
    for b in range(B):
        device_cond(insert[b], keyframe, lambda b: (), (b,), names=("keyframe", None))

    summary = torch.stack([
        feats.count.to(torch.float32),
        res["mvalid"].sum(-1).to(torch.float32),
        n_in.to(torch.float32),
        tracking.to(torch.float32),
        need_kf.to(torch.float32),
        new_states.map.valid.sum(-1).to(torch.float32),
        res["rmse"],
        threshold,
    ], dim=-1)
    summary = _by_row(active, summary, torch.zeros_like(summary))
    return new_states, {"R": new_states.R, "t": new_states.t, "summary": summary}


def _flags_on(active, B: int, device: torch.device) -> torch.Tensor:
    """The caller's ``active`` flags (host list, array or tensor) as a bool
    tensor on ``device``; host flags are copied once, from pinned memory
    without blocking on the card."""
    flags = active if isinstance(active, torch.Tensor) else torch.as_tensor(
        np.asarray(active, dtype=bool))
    flags = flags.to(torch.bool)
    if flags.device != device:
        if flags.device.type == "cpu" and device.type == "cuda":
            flags = flags.pin_memory()
        flags = flags.to(device, non_blocking=True)
    if flags.shape[0] != B:
        raise ValueError(f"{flags.shape[0]} rows of flags for {B} sequences")
    return flags


def _host_flags(active) -> np.ndarray | None:
    """The caller's flags as a host array where they are on the host; None
    for flags on the card (reading them would synchronize)."""
    if isinstance(active, torch.Tensor):
        return active.numpy().astype(bool) if active.device.type == "cpu" else None
    return np.asarray(active, dtype=bool)


def track_step_batch(cam: PinholeCamera, cfg: SlamConfig, states: VOState,
                     images: torch.Tensor, active, samplers: list[Sampler]
                     ) -> tuple[VOState, dict]:
    """One tracked frame of each of B independent sequences: the counterpart
    of the JAX package's ``vmap(track_step)``, decision for decision each
    sequence's own ``track_step``.

    ``states`` is a batched ``VOState`` (``VOState.stack``; left as it
    was), ``images`` (B, H, W) on its device, ``active`` (B,) bool (host
    list or tensor): an inactive sequence keeps its state and records a
    zero summary.  ``samplers[b]`` draws sequence b's relocalization
    samples, under its own key ``("reloc", frame_idx)``, so b draws what
    its ``track_step`` would.

    Nothing reads the device back outside a ``device_cond``: the common
    path runs over all B rows (extraction at each sequence's adaptive
    threshold in one K1 launch, the guided pass in one K2 launch and one
    batched PnP, the pose and velocity update, the summary), each rare
    branch is a ``device_cond`` of its own: the relocalization of a row
    that lost its last frame and the keyframe insertion with its window
    BA, one a row on that row, and the second PnP pass, one masked batched
    body run where any row asks for it.  Eagerly (the plain version) each
    of those conditions reads its predicate.  Returns the batched state and
    {"R" (B, 3, 3), "t" (B, 3), "summary" (B, len(SUMMARY_FIELDS))}.
    """
    B = states.R.shape[0]
    if len(samplers) != B or images.shape[0] != B:
        raise ValueError(f"track_step_batch: {B} states, {images.shape[0]} images and "
                         f"{len(samplers)} samplers")
    flags = _flags_on(active, B, states.device)
    return _step_batch(cam, cfg, _tree_map(torch.clone, states), images, flags, samplers)


# The branch bodies the batched graph's tally counts, summed over rows.
BATCH_BRANCHES = ("reloc", "reloc_global", "second_pass", "keyframe", "ba")
# The sites the batched graph stamps besides its bodies (``device_span``):
# K1, K2 in the guided pass and in the second pass (one shape), and each
# keyframe's two triangulations (``_insert_keyframe``).
BATCH_SITES = ("k1", "k2.track", "tri")


class BatchGraph(_StepGraph):
    """``track_chunk_batch`` on the card as replays of one captured
    batched step, the counterpart of the JAX package's jitted
    ``vmap(track_chunk)``: each ``device_cond`` of ``track_step_batch``
    (each row's relocalization with its global fallback, the second pass,
    each row's keyframe insertion with its window BA) is a conditional
    node, so a replay runs only the bodies its B frames take, and nothing
    reads the device back.

    Built by ``batch_graph`` for one camera, config, batch size, image
    shape and dtype, device and sampler types, never for a seed: the
    samplers' seeds are a (B,) int64 static buffer that the keyed draws
    read.  It first warms the step with every body run on a copy of the
    state, twice, the second time with any synchronization an error, then
    captures it over static buffers: the batched state (its map, window
    and ring written in place by the keyframe bodies, the rest by the
    graph's last nodes), the B images, the (B,) ``active`` flags and the
    seeds.  A failed capture raises.

    Each replay adds the launches of the graph outside its bodies to the
    kernels' counters at once; ``tally`` (int32, one slot a name of
    ``BATCH_BRANCHES``, cumulative, summed over rows) counts on the device
    the bodies that ran, and ``account`` adds their launches once the
    caller has read it back.  ``captured.stamps`` times each replay, each
    body and the sites of ``BATCH_SITES`` on the card (``utils/spans.py``);
    each chunk leaves a record of them (``spans.Chunk``).
    """

    def __init__(self, cam: PinholeCamera, cfg: SlamConfig, states: VOState,
                 images: torch.Tensor, samplers: list[Sampler]):
        dev = states.device
        if dev.type != "cuda":
            raise ValueError(f"BatchGraph: a state on {dev}; the graph runs on the card")
        B = states.R.shape[0]
        if images.shape[0] != B or len(samplers) != B:
            raise ValueError(f"BatchGraph: {B} states, {images.shape[0]} images and "
                             f"{len(samplers)} samplers")
        self.static = _tree_map(torch.clone, states)
        self.images = images.to(dev, copy=True)
        self.active = torch.ones(B, dtype=torch.bool, device=dev)
        self.seeds = torch.zeros(B, dtype=torch.int64, device=dev)
        keyed = [s.keyed_on(self.seeds[b]) for b, s in enumerate(samplers)]

        def step():
            new, ys = _step_batch(cam, cfg, self.static, self.images, self.active, keyed)
            for dst, src in zip(tree_leaves(self.static), tree_leaves(new)):
                if src is not dst:
                    dst.copy_(src)
            return ys["summary"]

        def warm_step():
            _step_batch(cam, cfg, _tree_map(torch.clone, self.static), self.images,
                        self.active, keyed)

        with CAPTURE_LOCK, counters_kept():
            warm_checked(warm_step, dev, BATCH_BRANCHES, BATCH_SITES)
            self._hold(capture(step, dev, BATCH_BRANCHES, sites=BATCH_SITES))

    def track_chunk(self, states: VOState, images: torch.Tensor, active,
                    samplers: list[Sampler]) -> tuple[VOState, dict]:
        """``track_chunk_batch``'s result for (B, C, H, W) images and (B, C)
        flags (host or device) on the card, with no host sync: the states
        and the samplers' seeds loaded once, then per step one copy of its
        images and flags into the static buffers, one replay and the
        copies of its poses and summaries.  A step where the host's flags
        show no active row is not replayed.  The returned state is a copy
        of the static one."""
        B, C = images.shape[:2]
        dev = self.images.device
        if images.shape[:1] + images.shape[2:] != self.images.shape or \
                images.dtype != self.images.dtype:
            raise ValueError(f"BatchGraph: images {tuple(images.shape)} {images.dtype} for "
                             f"a graph of {tuple(self.images.shape)} {self.images.dtype}")
        if len(samplers) != B:
            raise ValueError(f"BatchGraph: {len(samplers)} samplers for {B} sequences")
        rec = spans.Chunk("batch", C)
        host = _host_flags(active)
        flags = _flags_on(active, B, dev)
        if images.device != dev:
            images = images.pin_memory().to(dev, non_blocking=True)
        self._load(states)
        seeds = torch.tensor([seed_word(s) for s in samplers], dtype=torch.int64)
        self.seeds.copy_(seeds.pin_memory(), non_blocking=True)
        rec.loaded()
        Rs = torch.empty((B, C, 3, 3), dtype=torch.float32, device=dev)
        ts = torch.empty((B, C, 3), dtype=torch.float32, device=dev)
        summaries = torch.zeros((B, C, len(SUMMARY_FIELDS)), dtype=torch.float32, device=dev)
        n = 0
        for c in range(C):
            if host is None or host[:, c].any():
                self.images.copy_(images[:, c], non_blocking=True)
                self.active.copy_(flags[:, c], non_blocking=True)
                self.captured.graph.replay()
                summaries[:, c].copy_(self.summary)
                n += 1
            Rs[:, c].copy_(self.static.R)
            ts[:, c].copy_(self.static.t)
        rec.launched()
        self.replays += n
        add_launches([n * k for k in self.captured.base])
        out = _tree_map(torch.clone, self.static)
        rec.close(self.captured, n)
        return out, {"R": Rs, "t": ts, "summary": summaries}


_BATCH_GRAPHS: dict = {}


def batch_graph(cam: PinholeCamera, cfg: SlamConfig, states: VOState, images: torch.Tensor,
                samplers: list[Sampler]) -> BatchGraph:
    """The ``BatchGraph`` of this camera, config, batch size, (B, H, W)
    image shape and dtype, device and sampler types, captured at first use
    and kept for the process (graphs hold no state between chunks)."""
    key = (cam, cfg, tuple(images.shape), images.dtype, states.device,
           tuple(type(s) for s in samplers))
    if key not in _BATCH_GRAPHS:
        _BATCH_GRAPHS[key] = BatchGraph(cam, cfg, states, images, samplers)
    return _BATCH_GRAPHS[key]


def track_chunk_batch(cam: PinholeCamera, cfg: SlamConfig, states: VOState,
                      images: torch.Tensor, active, samplers: list[Sampler],
                      graph: bool = True) -> tuple[VOState, dict]:
    """Track B independent sequences a chunk of C frames each: the
    counterpart of the JAX package's ``vmap(track_chunk)``, each sequence
    as its own ``track_chunk`` would track it.

    ``images`` (B, C, H, W), ``active`` (B, C) bool (host lists or
    tensors), ``samplers`` one a sequence; see ``track_step_batch``.  On
    the card the chunk runs through the captured ``BatchGraph`` of this
    camera, config and shape (the launches of its branch bodies reach the
    kernels' counters when the caller reads its tally back and calls
    ``account``); ``graph=False``, or a state elsewhere, runs the plain
    ``track_step_batch`` a step, which the card's comparisons run beside
    it.  A step where the host's flags show no active row is skipped.
    Returns the batched state and {"R" (B, C, 3, 3), "t" (B, C, 3),
    "summary" (B, C, len(SUMMARY_FIELDS))}.
    """
    dev = states.device
    if dev.type == "cuda" and graph:
        return batch_graph(cam, cfg, states, images[:, 0], samplers).track_chunk(
            states, images, active, samplers)
    B, C = images.shape[:2]
    if len(samplers) != B:
        raise ValueError(f"track_chunk_batch: {B} sequences and {len(samplers)} samplers")
    rec = spans.Chunk("plain", C)
    host = _host_flags(active)
    flags = _flags_on(active, B, dev)
    states = _tree_map(torch.clone, states)
    rec.loaded()
    Rs, ts, summaries = [], [], []
    for c in range(C):
        if host is not None and not host[:, c].any():
            ys = {"R": states.R, "t": states.t,
                  "summary": torch.zeros((B, len(SUMMARY_FIELDS)), dtype=torch.float32,
                                         device=dev)}
        else:
            states, ys = _step_batch(cam, cfg, states, images[:, c], flags[:, c], samplers)
        Rs.append(ys["R"])
        ts.append(ys["t"])
        summaries.append(ys["summary"])
    rec.launched()
    out = {"R": torch.stack(Rs, 1), "t": torch.stack(ts, 1), "summary": torch.stack(summaries, 1)}
    rec.close()
    return states, out


@dataclass
class DeviceVO:
    """Host shell around the tracker.  Until the bootstrap succeeds each
    frame runs the host-stepped ``VisualOdometry`` on ``device`` (K1 and K2
    launch there too); after that frames are buffered and tracked a chunk
    at a time, and per-frame poses and summaries reach the host in
    ``flush``, apart from one readback of a chunk's tracking flags that
    counts lost frames::

        vo = DeviceVO(cfg, camera, chunk=8, device="cuda")
        for frame in frames:
            vo.process(frame)
        vo.flush()
        traj = vo.positions        # (T, 3) camera centres

    After ``cfg.vo.reloc_max_frames`` lost frames in a row the tracker
    drops its state and bootstraps a fresh submap, whose world frame is
    anchored at the last known pose (``_base``), so poses and points stay
    in the first submap's frame (``submap_events``, ``num_reboots``).
    ``sampler`` supplies every RANSAC draw (a ``Sampler(0)`` if None).
    ``device`` is required: the host phase, the handed-over state and every
    tracked chunk live there.  A ``VOState`` assigned to ``state`` skips the
    bootstrap; it must lie on ``device``.  On the card a chunk runs through
    the captured ``ChunkGraph`` of this camera, config and image shape
    (``graph=False``: the plain ``track_chunk``, which the card's
    comparisons run beside it); on the CPU it runs ``track_chunk``.
    """

    cfg: SlamConfig
    camera: PinholeCamera
    chunk: int = 16
    sampler: Sampler | None = None
    device: str | torch.device = dataclasses.field(kw_only=True)
    graph: bool = dataclasses.field(default=True, kw_only=True)

    def __post_init__(self):
        if not isinstance(self.cfg, SlamConfig):
            raise TypeError("cfg must be a SlamConfig")
        if not 1 <= self.chunk <= KF_RING:
            raise ValueError(f"chunk={self.chunk} outside 1..KF_RING={KF_RING}")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            # Tensors report their index: compare states against cuda:N.
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.sampler is None:
            self.sampler = Sampler()
        self._host = VisualOdometry(self.cfg, self.camera, device=self.device,
                                    sampler=self.sampler)
        self.state = None
        self._buf: list = []
        self._pending: list[tuple[int, dict]] = []
        self.trajectory: list[tuple[np.ndarray, np.ndarray]] = []
        self.stats: list[VOStats] = []
        self._frame_idx = -1
        # Global world -> current submap's world; the device state is kept
        # global (the base is folded in when the host phase hands over).
        self._base = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self._host_frame0 = 0       # global frame of the host's frame 0
        self.host_frames = 0        # frames processed on the host path
        self._lost_streak = 0
        self.num_reboots = 0
        self.submap_events: list[dict] = []
        # Called just before a reboot discards the device state.
        self.pre_reboot_hook = None

    @property
    def state(self) -> VOState | None:
        """The device tracker's state; None until the bootstrap hands over."""
        return self._state

    @state.setter
    def state(self, value: VOState | None) -> None:
        if value is not None and value.device != self.device:
            raise ValueError(f"a VOState on {value.device} assigned to a DeviceVO "
                             f"on {self.device}")
        self._state = value

    # -------- submap chaining --------
    def _apply_base_to_host(self) -> None:
        """Fold the submap base into the freshly bootstrapped host tracker
        so that every pose and point it hands over is global: a submap pose
        T_l becomes T_l o T_base, a point X_l becomes R_b^T (X_l - t_b)."""
        R_b, t_b = self._base
        if np.allclose(R_b, np.eye(3)) and np.allclose(t_b, 0.0):
            return
        h = self._host
        Rb = torch.from_numpy(R_b).to(self.device)
        tb = torch.from_numpy(t_b).to(self.device)
        h.win_R, h.win_t = (torch.einsum("kij,jl->kil", h.win_R, Rb),
                            torch.einsum("kij,j->ki", h.win_R, tb) + h.win_t)
        h.R, h.t = se3_compose(h.R, h.t, Rb, tb)
        h.kf_pose = se3_compose(*h.kf_pose, Rb, tb)
        h.kf_poses_log = [(k, R @ R_b, R @ t_b + t) for k, R, t in h.kf_poses_log]
        h.map = h.map.replace(
            X=torch.where(h.map.valid[:, None], (h.map.X - tb) @ Rb, h.map.X))
        self._base = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))

    def _reboot(self) -> None:
        """Relocalization failed for ``reloc_max_frames`` frames: drop the
        state and bootstrap a fresh submap anchored at the last pose."""
        self._drain()
        if self.pre_reboot_hook is not None:
            self.pre_reboot_hook()
        if self.trajectory:
            R_last, t_last = self.trajectory[-1]
            self._base = (np.asarray(R_last, np.float32).copy(),
                          np.asarray(t_last, np.float32).copy())
        self.state = None
        self._host.reset()
        self._host_frame0 = self._frame_idx + 1
        self._lost_streak = 0
        self.num_reboots += 1
        self.submap_events.append({"frame": self._frame_idx, "base": self._base})

    # -------- bootstrap state handoff --------
    def _lift_state(self) -> VOState:
        h = self._host
        dev = self.device
        empty = Features.empty(self.cfg.frontend.max_features, dev)
        slots = [f if f is not None else empty for f in h.win_feats]
        ring = {0: h.kf0_feats} if h.kf0_feats is not None else {}
        for slot in range(len(h.win_valid)):
            if h.win_valid[slot] and h.win_feats[slot] is not None:
                ring[int(h.win_kf_id[slot])] = h.win_feats[slot]
        kf_ring = empty.map(lambda x: x.expand(KF_RING, *x.shape).clone())
        for kf_id, f in ring.items():
            kf_ring = Features(**{n: set_row(getattr(kf_ring, n), kf_id % KF_RING,
                                             getattr(f, n)) for n in _FEATURE_FIELDS})
        i32 = dict(dtype=torch.int32, device=dev)
        return VOState(
            map=h.map, win_R=h.win_R, win_t=h.win_t, win_obs=h.win_obs,
            win_mask=h.win_mask, win_valid=torch.as_tensor(h.win_valid, device=dev),
            win_kf_id=torch.as_tensor(h.win_kf_id, **i32),
            win_feats=Features(**{n: torch.stack([getattr(f, n) for f in slots])
                                  for n in _FEATURE_FIELDS}),
            kf_ring=kf_ring, R=h.R, t=h.t, vel_R=h.vel[0], vel_t=h.vel[1],
            num_keyframes=torch.tensor(h.num_keyframes, **i32),
            frames_since_kf=torch.tensor(h.frames_since_kf, **i32),
            frame_idx=torch.tensor(h.frame_idx + 1, **i32),
            last_tracking=torch.tensor(bool(h.stats[-1].tracking) if h.stats else True,
                                       device=dev),
            threshold=h.frontend._threshold.to(dev).clone())

    # -------- frame ingestion --------
    def process(self, image) -> None:
        """Queue one (H, W) frame (numpy array or tensor).  Until the
        bootstrap succeeds it runs the host phase at once; after that a
        full chunk is tracked at once."""
        self._frame_idx += 1
        if self.state is None:
            self.host_frames += 1
            st = self._host.process(image)
            R_l, t_l = self._host.trajectory[-1]
            R_b, t_b = self._base
            self.trajectory.append((R_l @ R_b, R_l @ t_b + t_l))
            self.stats.append(st)
            if self._host.initialized:
                self._apply_base_to_host()
                self.state = self._lift_state()
            return
        self._buf.append(image)
        if len(self._buf) >= self.chunk:
            self._dispatch()

    def _dispatch(self) -> None:
        n = len(self._buf)
        if n == 0:
            return
        dev = self.device
        buf = self._buf + [self._buf[-1]] * (self.chunk - n)
        if all(isinstance(im, np.ndarray) for im in buf):
            images = torch.from_numpy(np.stack(buf))              # one upload
            if dev.type == "cuda":
                images = images.pin_memory().to(dev, non_blocking=True)
        else:
            images = torch.stack([torch.as_tensor(im, device=dev) for im in buf])
        active = [True] * n + [False] * (self.chunk - n)
        self._buf = []
        graph = None
        if dev.type == "cuda" and self.graph:
            graph = chunk_graph(self.camera, self.cfg, self.state, images[0], self.sampler)
            self.state, ys = graph.track_chunk(self.state, images, active)
        else:
            self.state, ys = track_chunk(self.camera, self.cfg, self.state,
                                         images, active, self.sampler)
        rebooting = self.cfg.vo.reloc_max_frames > 0
        if rebooting:
            # One readback a chunk: its tracking flags, to count lost frames,
            # and the graph's tally (else read in _drain).
            flags = ys["summary"][:n, 3]
            if graph is not None:
                flags = torch.cat([flags, graph.tally.to(torch.float32)])
            flags = flags.tolist()
            if graph is not None:
                graph.account(flags[n:])
                graph = None
            for tracked in flags[:n]:
                self._lost_streak = 0 if tracked > 0.5 else self._lost_streak + 1
        self._pending.append((n, ys, graph))
        if rebooting and self._lost_streak >= self.cfg.vo.reloc_max_frames:
            self._reboot()

    def flush(self) -> None:
        """Track any partial chunk and bring all pending poses and summaries
        to the host."""
        self._dispatch()
        self._drain()

    def _drain(self) -> None:
        for n, ys, graph in self._pending:
            R = ys["R"][:n].cpu().numpy()
            t = ys["t"][:n].cpu().numpy()
            s = ys["summary"][:n].cpu().numpy()
            if graph is not None:
                graph.account(graph.tally.tolist())
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
    def initialized(self) -> bool:
        return self.state is not None

    @property
    def num_keyframes(self) -> int:
        if self.state is None:
            return self._host.num_keyframes
        return int(self.state.num_keyframes)

    @property
    def map(self) -> MapState:
        """Landmark slotmap (the host phase's before the handover)."""
        return self._host.map if self.state is None else self.state.map

    @property
    def force_reloc(self) -> bool:
        """Setting True forces relocalization on the next tracked frame (on
        the device the trigger is ``last_tracking``)."""
        if self.state is None:
            return self._host.force_reloc
        return not bool(self.state.last_tracking)

    @force_reloc.setter
    def force_reloc(self, value: bool) -> None:
        if self.state is None:
            self._host.force_reloc = bool(value)
        elif value:
            self.state = self.state.replace(last_tracking=torch.zeros(
                (), dtype=torch.bool, device=self.device))

    @property
    def positions(self) -> np.ndarray:
        """Camera centres (world frame); call flush() first."""
        return np.asarray([-R.T @ t for R, t in self.trajectory])
