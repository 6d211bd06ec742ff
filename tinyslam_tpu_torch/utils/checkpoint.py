"""Checkpoint / resume of the trackers and of the loop-closure layer
(mirrors ``tinyslam_tpu/utils/checkpoint.py``).

The map, the keyframe window, the trajectory and the loop-closure tables
are written as the JAX package writes them, with its dispatch, its fields
and its meta files (``meta.json``, ``device_meta.json``, ``slam_meta.json``,
format version 2), but the arrays go into ``.npz`` files, read back with
``allow_pickle=False``, where the JAX package writes Orbax checkpoints.
Their names are the flat field paths of ``VOState.to_numpy``,
``MapState.to_numpy`` and ``Features.to_numpy``.  A checkpoint holds no
device: one written on the card restores onto the CPU and the other way
round, onto the device of the instance it is restored into.

Three additions to the JAX package's format, all in the ``.npz`` files,
each needed for a restored instance to go on as the saved one would:

- The RANSAC draws.  The JAX package derives every key from a frame
  number, so it carries no random state; the port draws from a
  ``Sampler`` that owns a ``torch.Generator`` and the seed of its keyed
  relocalization stream.  Both are saved once,
  with the tracker that draws from it (``Slam`` hands its sampler to its
  tracker, ``DeviceVO`` to its host phase), so a restored tracker draws
  what the uninterrupted one would.  A sampler without a generator (a
  replay of fixed streams) carries no state.
- The host tracker's bootstrap reference (``kf0_feats`` and its frame).
  Without it a tracker restored before its bootstrap starts the two-view
  search over from the next frame, where the uninterrupted one would not.
- The loop-closure cooldown (``Slam._loop_cooldown_until``).  Without it
  a restored ``Slam`` probes, and may close, loops that the saved one
  would have skipped.

The JAX package's own gaps are kept: ``Slam.kf_frame_of``,
``DeviceSlam._kf_frame`` and the host tracker's keyframe logs are not
saved.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tinyslam_tpu_torch.types import Features

FORMAT_VERSION = 2


def _write_npz(path: Path, arrays: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def _read_npz(path: Path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _sampler_state(sampler) -> dict:
    """{"sampler": its generator's state, "sampler_seed": the seed of its
    keyed stream}, or {} without a generator."""
    if not hasattr(sampler, "generator"):
        return {}
    return {"sampler": sampler.generator.get_state().numpy(),
            "sampler_seed": np.asarray(sampler.seed, np.int64)}


def _restore_sampler(sampler, arrays: dict) -> None:
    if "sampler" in arrays and hasattr(sampler, "generator"):
        sampler.generator.set_state(torch.from_numpy(arrays["sampler"]))
        if "sampler_seed" in arrays:
            sampler.seed = int(arrays["sampler_seed"])


def _pose_list(poses) -> list:
    return [[np.asarray(R).tolist(), np.asarray(t).tolist()] for R, t in poses]


def _poses_from(items) -> list:
    return [(np.asarray(R, np.float32), np.asarray(t, np.float32)) for R, t in items]


# ---------------- VisualOdometry (host-stepped) ----------------

def _vo_arrays(vo) -> dict:
    cap = vo.cfg.frontend.max_features
    empty = Features.empty(cap)
    out = vo.map.to_numpy("map.")
    for name, x in (("window.R", vo.win_R), ("window.t", vo.win_t),
                    ("window.obs", vo.win_obs), ("window.mask", vo.win_mask),
                    ("pose.R", vo.R), ("pose.t", vo.t),
                    ("vel.R", vo.vel[0]), ("vel.t", vo.vel[1]),
                    ("kf_pose.R", vo.kf_pose[0]), ("kf_pose.t", vo.kf_pose[1])):
        out[name] = x.detach().cpu().numpy()
    out.update((vo.kf_feats if vo.kf_feats is not None else empty).to_numpy("kf_feats."))
    for i, f in enumerate(vo.win_feats):
        out.update((f if f is not None else empty).to_numpy(f"win_feats.{i}."))
    if vo.kf0_feats is not None:
        out.update(vo.kf0_feats.to_numpy("kf0_feats."))
        out["kf0_frame"] = np.asarray(vo._kf0_frame, np.int64)
    return out


def save_vo(vo, path) -> None:
    """Checkpoint a ``VisualOdometry`` or ``DeviceVO`` (or ``Slam().vo``)."""
    if hasattr(vo, "state"):                  # DeviceVO
        save_device_vo(vo, path)
        return
    path = Path(path).resolve()
    arrays = _vo_arrays(vo)
    arrays.update(_sampler_state(vo.sampler))
    _write_npz(path / "arrays.npz", arrays)
    meta = {
        "win_valid": np.asarray(vo.win_valid).tolist(),
        "win_kf_id": np.asarray(vo.win_kf_id).tolist(),
        "num_keyframes": vo.num_keyframes,
        "frame_idx": vo.frame_idx,
        "frames_since_kf": vo.frames_since_kf,
        "initialized": vo.initialized,
        "has_kf_feats": vo.kf_feats is not None,
        "win_feats_present": [f is not None for f in vo.win_feats],
        "frontend_threshold": vo.frontend.threshold,
        "trajectory": _pose_list(vo.trajectory),
    }
    (path / "meta.json").write_text(json.dumps(meta))


def restore_vo(vo, path) -> None:
    """Restore what ``save_vo`` wrote into a freshly built instance of the
    same config, on that instance's device.  The continuation is the one
    the saved instance would have tracked; crash recovery, where the pose
    is stale by the frames since the snapshot, is
    ``SnapshotPolicy.restore_latest``, which also forces a relocalization."""
    if hasattr(vo, "state"):                  # DeviceVO
        restore_device_vo(vo, path)
        return
    from tinyslam_tpu_torch.models.vo import MapState

    path = Path(path).resolve()
    a = _read_npz(path / "arrays.npz")
    meta = json.loads((path / "meta.json").read_text())
    dev = vo.device

    def t(name):
        return torch.from_numpy(a[name]).to(dev)

    vo.map = MapState.from_numpy(a, dev, "map.")
    vo.win_R, vo.win_t = t("window.R"), t("window.t")
    vo.win_obs, vo.win_mask = t("window.obs"), t("window.mask")
    vo.R, vo.t = t("pose.R"), t("pose.t")
    vo.vel = (t("vel.R"), t("vel.t"))
    vo.kf_pose = (t("kf_pose.R"), t("kf_pose.t"))
    if meta.get("has_kf_feats", False):
        vo.kf_feats = Features.from_numpy(a, dev, "kf_feats.")
    present = meta.get("win_feats_present", [False] * len(vo.win_feats))
    vo.win_feats = [Features.from_numpy(a, dev, f"win_feats.{i}.") if p else None
                    for i, p in enumerate(present)]
    if "kf0_frame" in a:
        vo.kf0_feats = Features.from_numpy(a, dev, "kf0_feats.")
        vo._kf0_frame = int(a["kf0_frame"])
    vo.win_valid = np.asarray(meta["win_valid"], bool)
    vo.win_kf_id = np.asarray(meta["win_kf_id"], np.int64)
    vo.num_keyframes = meta["num_keyframes"]
    vo.frame_idx = meta["frame_idx"]
    vo.frames_since_kf = meta["frames_since_kf"]
    vo.initialized = meta["initialized"]
    vo.frontend.threshold = meta.get("frontend_threshold", vo.frontend.threshold)
    vo.trajectory = _poses_from(meta["trajectory"])
    _restore_sampler(vo.sampler, a)


# ---------------- DeviceVO (device-resident VOState) ----------------

def save_device_vo(dvo, path) -> None:
    """Checkpoint a ``DeviceVO``: the ``VOState`` into ``state.npz``, the
    host-side bookkeeping (trajectory, stats, submaps) into
    ``device_meta.json``.  Pending chunks are flushed first.  Before the
    bootstrap it is the host phase's checkpoint, under ``host/``."""
    path = Path(path).resolve()
    dvo.flush()
    if dvo.state is None:
        save_vo(dvo._host, path / "host")        # with the shared sampler
        meta = {"device": False, "frame_idx": dvo._frame_idx}
        (path / "device_meta.json").write_text(json.dumps(meta))
        return
    arrays = dvo.state.to_numpy()
    arrays.update(_sampler_state(dvo.sampler))
    _write_npz(path / "state.npz", arrays)
    meta = {
        "device": True,
        "frame_idx": dvo._frame_idx,
        "base": [np.asarray(dvo._base[0]).tolist(), np.asarray(dvo._base[1]).tolist()],
        "lost_streak": dvo._lost_streak,
        "num_reboots": dvo.num_reboots,
        "submap_events": [
            {"frame": e["frame"],
             "base": [np.asarray(e["base"][0]).tolist(), np.asarray(e["base"][1]).tolist()]}
            for e in dvo.submap_events],
        "trajectory": _pose_list(dvo.trajectory),
        "stats": [
            {"frame": s.frame, "num_features": s.num_features,
             "num_matches": s.num_matches, "num_inliers": s.num_inliers,
             "num_landmarks": s.num_landmarks, "is_keyframe": s.is_keyframe,
             "tracking": s.tracking, "rmse_px": s.rmse_px}
            for s in dvo.stats],
    }
    (path / "device_meta.json").write_text(json.dumps(meta))


def restore_device_vo(dvo, path) -> None:
    """Restore ``save_device_vo`` output into a fresh ``DeviceVO`` of the
    same config, on its device."""
    from tinyslam_tpu_torch.models.vo import VOStats
    from tinyslam_tpu_torch.models.vo_device import VOState

    path = Path(path).resolve()
    meta = json.loads((path / "device_meta.json").read_text())
    if not meta["device"]:
        restore_vo(dvo._host, path / "host")
        dvo._frame_idx = meta["frame_idx"]
        dvo.trajectory = list(dvo._host.trajectory)
        dvo.stats = list(dvo._host.stats)
        if dvo._host.initialized:
            dvo.state = dvo._lift_state()
        return
    arrays = _read_npz(path / "state.npz")
    dvo.state = VOState.from_numpy(arrays, dvo.device)
    _restore_sampler(dvo.sampler, arrays)
    dvo._frame_idx = meta["frame_idx"]
    dvo.trajectory = _poses_from(meta["trajectory"])
    dvo.stats = [VOStats(**s) for s in meta["stats"]]
    if "base" in meta:
        dvo._base = tuple(np.asarray(b, np.float32) for b in meta["base"])
    dvo._lost_streak = meta.get("lost_streak", 0)
    dvo.num_reboots = meta.get("num_reboots", 0)
    dvo.submap_events = [
        {"frame": e["frame"], "base": tuple(np.asarray(b, np.float32) for b in e["base"])}
        for e in meta.get("submap_events", [])]


# ---------------- Slam (tracker + loop-closure state) ----------------

def save_slam(slam, path) -> None:
    """Checkpoint a ``Slam`` or ``DeviceSlam``: the tracker under ``vo/``,
    then the loop-closure layer (per-keyframe features, signatures, poses
    and association snapshots, the pose-graph edges)."""
    path = Path(path).resolve()
    save_vo(slam.vo, path / "vo")
    arrays = {}
    for k, f in enumerate(slam.kf_store):
        arrays.update(f.to_numpy(f"kf_store.{k}."))
        arrays[f"kf_R.{k}"] = np.asarray(slam.kf_R[k], np.float32)
        arrays[f"kf_t.{k}"] = np.asarray(slam.kf_t[k], np.float32)
        arrays[f"kf_signatures.{k}"] = np.asarray(slam.kf_signatures[k], np.float32)
        arrays[f"kf_lm_X.{k}"] = np.asarray(slam.kf_assoc[k][0], np.float32)
        arrays[f"kf_lm_ok.{k}"] = np.asarray(slam.kf_assoc[k][1], bool)
    arrays["loop_cooldown_until"] = np.asarray(slam._loop_cooldown_until, np.int64)
    _write_npz(path / "slam_arrays.npz", arrays)
    meta = {
        # Format history: v1 (unversioned) = SE(3)-only 5-tuple edges,
        # index-based kf_lm_idx associations; v2 = Sim(3) 6-tuple edges +
        # 3D-snapshot kf_lm_X associations + submap kf_offset.
        "format_version": FORMAT_VERSION,
        "num_keyframes": len(slam.kf_store),
        "num_loop_closures": slam.num_loop_closures,
        "kf_offset": getattr(slam, "_kf_offset", 0),
        "edges": [[int(i), int(j), np.asarray(R).tolist(), np.asarray(t).tolist(),
                   float(s), float(w)] for i, j, R, t, s, w in slam.edges],
    }
    (path / "slam_meta.json").write_text(json.dumps(meta))


def restore_slam(slam, path) -> None:
    """Restore ``save_slam`` output into a fresh ``Slam``/``DeviceSlam`` of
    the same config, on its device."""
    path = Path(path).resolve()
    meta = json.loads((path / "slam_meta.json").read_text())
    version = meta.get("format_version", 1)
    if version != FORMAT_VERSION:
        raise ValueError(
            f"incompatible Slam checkpoint format {version} (expected 2): "
            "pre-r5 checkpoints stored live-map landmark indices, which "
            "cannot be migrated to 3D association snapshots — re-run the "
            "sequence or restore with the matching framework version")
    restore_vo(slam.vo, path / "vo")
    a = _read_npz(path / "slam_arrays.npz")
    n = meta["num_keyframes"]
    slam.kf_store = [Features.from_numpy(a, slam.device, f"kf_store.{k}.") for k in range(n)]
    slam.kf_R = [a[f"kf_R.{k}"] for k in range(n)]
    slam.kf_t = [a[f"kf_t.{k}"] for k in range(n)]
    slam.kf_signatures = [a[f"kf_signatures.{k}"] for k in range(n)]
    slam.kf_assoc = [(a[f"kf_lm_X.{k}"], a[f"kf_lm_ok.{k}"]) for k in range(n)]
    slam._loop_cooldown_until = int(a.get("loop_cooldown_until", 0))
    if hasattr(slam, "_kf_offset"):
        slam._kf_offset = meta.get("kf_offset", 0)
    slam.num_loop_closures = meta["num_loop_closures"]
    slam.edges = [(int(i), int(j), np.asarray(R, np.float32), np.asarray(t, np.float32),
                   float(s), float(w)) for i, j, R, t, s, w in meta["edges"]]
