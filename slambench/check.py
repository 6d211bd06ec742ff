"""The comparison that decides ``correct``.

Two checks, each on the chunks drawn from the seed; a number decides
``correct`` where the workload states a limit for it (``check.limits``),
and is reported as observed otherwise:

- **The ground truth** (``gt_turn_deg``), written here and nowhere else:
  for each sampled chunk and stream, the program's rotation from the
  chunk's first tracked frame to its last is set against the generator's
  ground-truth rotation between the same frames; ``gt_turn_deg`` is the
  largest angle between the two.  A turn within a chunk needs no fit of
  the tracker's world to the truth's and carries none of the drift
  gathered before the chunk, and a fault that the reference shares (a
  wrong PnP, BA or keyframe rule, poses answered from the wrong frame)
  shows here.  It holds the tracker to the scene, so it reads the
  tracker's own failures too (a wrong relocalization reads tens of
  degrees).
- **The witness** (``pose_gap``, ``count_gap``): the plain reference under
  ``slambench/reference/``, a frozen copy of the port's plain tracker on
  plain PyTorch that imports nothing of the port, tracks each sampled
  chunk from the state the program held when the chunk went in, and its
  poses, per-frame counts and final state are set against the program's
  (the final state against the one the program starts the next chunk from,
  so that a state not carried over shows).  ``pose_gap``: the largest
  absolute difference of an entry of a tracked frame's rotation or
  translation (world->camera), or of the pose and map points of the state
  after the chunk (MISMATCH where they keep other map slots);
  ``count_gap``: of a per-frame count or flag (features, matches, inliers,
  landmarks, tracking, keyframe).  It shows that the captured graphs and
  the kernels compute what the plain code computes, to the bit.

``control="tf32"`` puts the reference, computed with TF32 matrix
products, in the program's place: the comparison has to call that wrong.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json

import numpy as np
import torch

COUNT_FIELDS = ("num_features", "num_matches", "num_inliers", "num_landmarks", "tracking",
                "is_keyframe")
MISMATCH = 1e9


def reference():
    """The reference's modules (imported here, never before the window)."""
    from slambench.reference.tslam import config, types
    from slambench.reference.tslam.geometry import camera
    from slambench.reference.tslam.models import vo, vo_device
    from slambench.reference.tslam.utils import draws

    return dict(config=config, types=types, camera=camera, vo=vo, vo_device=vo_device,
                draws=draws)


def ref_setup(config: dict):
    ref = reference()
    cfg = ref["config"].SlamConfig.from_json(json.dumps(config["slam"]))
    c = config["camera"]
    cam = ref["camera"].PinholeCamera.create(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"])
    return ref, cfg, cam


def to_reference(obj, ref):
    """A program state (dataclasses of tensors) as the reference's classes,
    every tensor cloned."""
    classes = {"VOState": ref["vo_device"].VOState, "MapState": ref["vo"].MapState,
               "Features": ref["types"].Features}
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj):
        cls = classes[type(obj).__name__]
        return cls(**{f.name: to_reference(getattr(obj, f.name), ref)
                      for f in dataclasses.fields(obj)})
    return obj


def clone_tree(obj):
    """A dataclass of tensors with every tensor cloned."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: clone_tree(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


@contextlib.contextmanager
def precision(control: str | None):
    """float32 matrix products as the configuration states them, or TF32
    for the control."""
    tf32 = control == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def summary_rows(summary) -> np.ndarray:
    """The reference's (n, 8) packed summaries as rows of COUNT_FIELDS."""
    s = np.asarray(summary, np.float64)
    # SUMMARY_FIELDS: features, matches, inliers, tracking, keyframe,
    # landmarks, rmse, threshold; read as DeviceVO reads them.
    counts = np.trunc(s[:, [0, 1, 2, 5]])
    flags = (s[:, [3, 4]] != 0).astype(np.float64)
    return np.concatenate([counts, flags], -1)


def largest_gap(a, b) -> float:
    """The largest absolute difference of two arrays, NaN against NaN
    counting as equal and NaN against a number as MISMATCH."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both = np.isnan(a) & np.isnan(b)
    d = np.where(both, 0.0, np.abs(a - b))
    d = np.where(np.isnan(d), MISMATCH, d)
    return float(d.max()) if d.size else 0.0


def gaps(R_a, t_a, rows_a, R_b, t_b, rows_b) -> tuple[float, float]:
    """(pose gap, count gap) of one set of answers against another."""
    return max(largest_gap(R_a, R_b), largest_gap(t_a, t_b)), largest_gap(rows_a, rows_b)


def state_gap(a, b) -> float:
    """The pose and map points of one tracker state against another's
    (MISMATCH where they keep other map slots)."""
    if not torch.equal(a.map.valid.cpu(), b.map.valid.cpu()):
        return MISMATCH
    v = a.map.valid.cpu().numpy()
    return max(largest_gap(a.R.cpu(), b.R.cpu()), largest_gap(a.t.cpu(), b.t.cpu()),
               largest_gap(a.map.X.cpu().numpy()[v], b.map.X.cpu().numpy()[v]))



def turn_deg(R, R_gt) -> float:
    """The angle in degrees between a tracker's turn from its first to its
    last frame and the ground truth's (world->camera rotations R, R_gt
    (n, 3, 3) of the same frames, n >= 2)."""
    R, R_gt = np.asarray(R, np.float64), np.asarray(R_gt, np.float64)
    return float(rotation_deg((R[-1] @ R[0].T)[None], (R_gt[-1] @ R_gt[0].T)[None])[0])


def rotation_deg(R, R_gt) -> np.ndarray:
    """Per frame, the angle in degrees of the rotation that carries the
    ground truth's world->camera rotation onto the tracker's (R, R_gt
    (n, 3, 3))."""
    R, R_gt = np.asarray(R, np.float64), np.asarray(R_gt, np.float64)
    # |R - R_gt| (Frobenius) is 2 sqrt(2) sin(angle / 2): exact near 0,
    # where the trace's arccos is not.
    chord = np.linalg.norm(R - R_gt, axis=(-2, -1)) / (2.0 * np.sqrt(2.0))
    return np.degrees(2.0 * np.arcsin(np.clip(chord, 0.0, 1.0)))
