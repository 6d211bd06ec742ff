"""The port's ``SnapshotPolicy`` and ``Heartbeat`` (``utils/faults.py``),
mirroring ``tests/test_faults.py``: the snapshot cadence and history,
a truncated snapshot skipped on restore, the forced relocalization after
a restore, a tracker killed mid-sequence and resumed from its newest
snapshot at 160x120, and a heartbeat that answers and one that hangs."""

from __future__ import annotations

import time

import torch

from tests import torch_parity as P
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models.vo import VisualOdometry
from tinyslam_tpu_torch.utils.draws import Sampler
from tinyslam_tpu_torch.utils.faults import Heartbeat, SnapshotPolicy

CAM = PinholeCamera.create(**P.CAMERA)


def _vo():
    return VisualOdometry(P.torch_config(keyframes=True), CAM, device="cpu",
                          sampler=Sampler(0))


def test_snapshot_cadence_and_history(tmp_path):
    policy = SnapshotPolicy(tmp_path, every_keyframes=2, keep=2)
    vo = _vo()
    taken = []
    for n in range(1, 8):
        vo.num_keyframes = n
        taken.append(policy.maybe_snapshot(vo))
    assert [p.name if p else None for p in taken] == [
        None, "snap_000002", None, "snap_000004", None, "snap_000006", None]
    assert [p.name for p in policy.snapshots()] == ["snap_000004", "snap_000006"]


def test_restore_skips_a_truncated_snapshot(tmp_path):
    policy = SnapshotPolicy(tmp_path, every_keyframes=1, keep=3)
    vo = _vo()
    for n in (1, 2):
        vo.num_keyframes = n
        vo.frame_idx = 10 * n
        policy.maybe_snapshot(vo)
    newest = tmp_path / "snap_000002" / "arrays.npz"
    newest.write_bytes(newest.read_bytes()[:100])          # a crash mid-save
    fresh = _vo()
    assert not fresh.force_reloc
    assert policy.restore_latest(fresh) == tmp_path / "snap_000001"
    assert fresh.frame_idx == 10 and fresh.num_keyframes == 1
    assert fresh.force_reloc
    assert [p.name for p, _ in policy.skipped] == ["snap_000002"]
    assert SnapshotPolicy(tmp_path / "empty").restore_latest(_vo()) is None


def test_snapshot_crash_restore_resumes_tracking(tmp_path):
    """Kill the tracker at frame 30 of a 46-frame orbit; a fresh instance
    restored from the newest periodic snapshot relocalizes against the
    restored map and tracks the remaining frames, at most 3 lost."""
    images = P.orbit(46)[0]
    policy = SnapshotPolicy(tmp_path, every_keyframes=1, keep=2)
    vo = _vo()
    crash_at = 30
    for im in images[:crash_at]:
        vo.process(im)
        policy.maybe_snapshot(vo)
    assert policy.snapshots() and len(policy.snapshots()) <= 2
    assert vo.num_keyframes >= 3
    del vo                                              # "crash"
    back = _vo()
    assert policy.restore_latest(back) is not None
    assert back.initialized and back.force_reloc
    n_restored = len(back.trajectory)
    tracked = sum(int(back.process(im).tracking) for im in images[crash_at:])
    assert tracked >= len(images) - crash_at - 3, tracked
    assert len(back.trajectory) == n_restored + len(images) - crash_at


def test_heartbeat_device_and_hang():
    hb = Heartbeat(timeout_s=5.0, device="cpu")
    assert hb.beat() and hb.missed == 0
    hung = Heartbeat(probe_fn=lambda: time.sleep(60), timeout_s=0.2)
    t0 = time.monotonic()
    assert not hung.beat()
    assert time.monotonic() - t0 < 1.0 and hung.missed == 1
    assert not hung.beat() and hung.missed == 2


def test_heartbeat_defaults_to_the_card():
    """No device named: the probe runs on the card, never the CPU.  A
    probe that raises (here: no card) is a missed beat, reported at once."""
    hb = Heartbeat(timeout_s=5.0)
    assert hb.device == torch.device("cuda")

    def broken():
        raise RuntimeError("no device")

    bad = Heartbeat(probe_fn=broken, timeout_s=5.0)
    t0 = time.monotonic()
    assert not bad.beat()
    assert time.monotonic() - t0 < 1.0
    assert bad.missed == 1 and isinstance(bad.last_error, RuntimeError)


def test_heartbeat_recovers():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(1.0)

    hb = Heartbeat(probe_fn=flaky, timeout_s=0.2, device="cpu")
    assert not hb.beat() and hb.missed == 1
    assert hb.beat() and hb.missed == 0
