"""Checkpoint / resume of the port's trackers (``utils/checkpoint.py``)
against the uninterrupted run and against the JAX package's format.

A tracker is saved mid-sequence, restored into a fresh instance, and both
go on through the same frames, with a relocalization forced in both: the
tracking flags, keyframe flags, feature, match, inlier and landmark counts
must be equal, camera centres within 1e-6, and both samplers must end in
the same state (the relocalization draws from them, so a checkpoint that
lost the sampler state fails here).  The set-up is ``torch_parity``'s
160x120 orbit with keyframes, under continuous bilinear BRIEF, as the JAX
package's own checkpoint test runs (``tests/test_checkpoint.py:14-22``).
A checkpoint written by the JAX package, read through Orbax, is carried
into the port and tracks as the JAX ``DeviceVO`` does, within
``tests/test_torch_tracking.py``'s tolerances.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu.frontend.orb import extract_features as jextract
from tinyslam_tpu.models.slam import Slam as JSlam
from tinyslam_tpu.models.vo import VisualOdometry as JVisualOdometry
from tinyslam_tpu.models.vo_device import DeviceVO as JDeviceVO
from tinyslam_tpu.models.vo_device import VOState as JVOState
from tinyslam_tpu.utils import checkpoint as jckpt
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models.slam import DeviceSlam, Slam
from tinyslam_tpu_torch.models.vo import VisualOdometry
from tinyslam_tpu_torch.models.vo_device import DeviceVO, VOState
from tinyslam_tpu_torch.utils.checkpoint import (
    restore_device_vo, restore_slam, restore_vo, save_device_vo, save_slam, save_vo,
)
from tinyslam_tpu_torch.utils.draws import Sampler

CAM = PinholeCamera.create(**P.CAMERA)


def _cfg():
    cfg = P.torch_config(keyframes=True)
    return dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, interpolate_descriptors=True))


@pytest.fixture(scope="module")
def frames():
    return P.orbit(30)[0]


def _counts(stats):
    return [(s.tracking, s.is_keyframe, s.num_features, s.num_matches, s.num_inliers,
             s.num_landmarks) for s in stats]


def _same_sampler(a, b):
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_visual_odometry_resumes_identically(tmp_path, frames):
    vo = VisualOdometry(_cfg(), CAM, device="cpu", sampler=Sampler(0))
    for f in frames[:14]:
        vo.process(f)
    assert vo.initialized and vo.num_keyframes >= 2
    save_vo(vo, tmp_path / "ck")
    back = VisualOdometry(_cfg(), CAM, device="cpu", sampler=Sampler(0))
    restore_vo(back, tmp_path / "ck")
    assert back.initialized and back.num_keyframes == vo.num_keyframes
    assert torch.equal(back.map.X, vo.map.X) and torch.equal(back.map.desc, vo.map.desc)
    out = []
    for i, f in enumerate(frames[14:26]):
        if i == 3:
            vo.force_reloc = back.force_reloc = True
        out.append((vo.process(f), back.process(f)))
    assert _counts([a for a, _ in out]) == _counts([b for _, b in out])
    assert all(a.tracking for a, _ in out)
    np.testing.assert_allclose(back.positions, vo.positions, rtol=0, atol=1e-6)
    _same_sampler(vo.sampler, back.sampler)


@pytest.mark.parametrize("saved_at", [2, 14])
def test_device_vo_resumes_identically(tmp_path, frames, saved_at):
    """Before the bootstrap (frame 2: the host phase's checkpoint, then
    ``_lift_state`` at the bootstrap) and after it (frame 14)."""
    vo = DeviceVO(_cfg(), CAM, chunk=4, device="cpu", sampler=Sampler(0))
    for f in frames[:saved_at]:
        vo.process(f)
    assert vo.initialized == (saved_at == 14)
    save_device_vo(vo, tmp_path / "ck")
    back = DeviceVO(_cfg(), CAM, chunk=4, device="cpu", sampler=Sampler(0))
    restore_device_vo(back, tmp_path / "ck")
    n_before = len(vo.stats)
    for i, f in enumerate(frames[saved_at:]):
        if i == 20 - saved_at:                    # a flushed frame after the bootstrap
            vo.flush()
            back.flush()
            vo.force_reloc = back.force_reloc = True
        vo.process(f)
        back.process(f)
    vo.flush()
    back.flush()
    n = len(vo.stats) - n_before
    assert _counts(back.stats[-n:]) == _counts(vo.stats[-n:])
    # host_frames is not saved (nor by the JAX package): it counts from the restore.
    assert back.host_frames == (vo.host_frames - saved_at if saved_at == 2 else 0)
    assert all(s.tracking for s in vo.stats[vo.host_frames - 1:])
    assert vo.stats[20].tracking and vo.stats[20].num_inliers > 20
    np.testing.assert_allclose(back.positions, vo.positions, rtol=0, atol=1e-6)
    _same_sampler(vo.sampler, back.sampler)


def test_device_slam_resumes_identically(tmp_path, frames):
    """DeviceSlam on the out-and-back of the orbit (frames 0-21, then
    20-0; ``loop_min_gap`` 3), saved at frame 24: the same keyframe
    tables, edges, loop decisions (the loop-closure cooldown is saved) and
    raw trajectory after it.
    (``kf_frame_of``, which the JAX package's checkpoint does not keep
    either, is rebuilt differently and is not compared.)"""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, pose_graph=dataclasses.replace(cfg.pose_graph,
                                                                  loop_min_gap=3))
    seq = frames[:22] + frames[20::-1]
    slam = DeviceSlam(cfg, CAM, chunk=4, device="cpu", sampler=Sampler(0))
    for f in seq[:24]:
        slam.process_frame(f)
    save_slam(slam, tmp_path / "ck")
    n_log = len(slam.loop_log)
    back = DeviceSlam(cfg, CAM, chunk=4, device="cpu", sampler=Sampler(0))
    restore_slam(back, tmp_path / "ck")
    assert len(back.kf_store) == len(slam.kf_store) >= 3
    for f in seq[24:]:
        slam.process_frame(f)
        back.process_frame(f)
    slam.finalize()
    back.finalize()
    assert len(back.kf_R) == len(slam.kf_R) == slam.vo.num_keyframes
    np.testing.assert_allclose(np.stack(back.kf_R), np.stack(slam.kf_R), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.stack(back.kf_t), np.stack(slam.kf_t), rtol=0, atol=1e-6)
    assert [e[:2] for e in back.edges] == [e[:2] for e in slam.edges]
    np.testing.assert_allclose([e[4] for e in back.edges], [e[4] for e in slam.edges],
                               rtol=0, atol=1e-6)
    keys = ("kf", "old", "n_appear", "num_inliers", "accepted")
    assert [tuple(r[k] for k in keys) for r in back.loop_log] == \
        [tuple(r[k] for k in keys) for r in slam.loop_log[n_log:]]
    assert back.num_loop_closures == slam.num_loop_closures
    assert _counts(back.vo.stats) == _counts(slam.vo.stats)
    np.testing.assert_allclose(back.raw_positions, slam.raw_positions, rtol=0, atol=1e-6)
    _same_sampler(slam.sampler, back.sampler)


def test_slam_format_1_is_refused(tmp_path):
    slam = Slam(_cfg(), CAM, device="cpu")
    save_slam(slam, tmp_path / "ck")
    meta_path = tmp_path / "ck" / "slam_meta.json"
    meta = json.loads(meta_path.read_text())
    assert meta["format_version"] == 2
    del meta["format_version"]                    # v1 was unversioned
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="incompatible Slam checkpoint format 1"):
        restore_slam(Slam(_cfg(), CAM, device="cpu"), tmp_path / "ck")


def _keys(path):
    return set(json.loads(path.read_text()))


def _seed(jcfg, tcfg):
    f0 = jextract(jnp.asarray(P.orbit(1)[0][0]), jnp.float32(jcfg.frontend.threshold),
                  jcfg.frontend)
    _, poses, room = P.orbit(1)
    return P.seeded_state(tcfg, P.features_numpy(f0), room, poses[0])


def test_meta_files_have_the_jax_keys(tmp_path):
    """Each meta file holds the JAX package's keys for the same state:
    the host tracker, DeviceVO before and after the bootstrap, Slam."""
    jcfg, tcfg = P.configs(keyframes=True)
    jcam, tcam = P.cameras()
    seed = _seed(jcfg, tcfg)
    pairs = {}
    jckpt.save_vo(JVisualOdometry(jcfg, jcam), tmp_path / "j_vo")
    save_vo(VisualOdometry(tcfg, tcam, device="cpu", sampler=Sampler(0)), tmp_path / "t_vo")
    pairs["meta.json"] = ("j_vo/meta.json", "t_vo/meta.json")
    jckpt.save_device_vo(JDeviceVO(jcfg, jcam, chunk=4), tmp_path / "j_boot")
    save_device_vo(DeviceVO(tcfg, tcam, chunk=4, device="cpu"), tmp_path / "t_boot")
    pairs["device_meta.json, before the bootstrap"] = ("j_boot/device_meta.json",
                                                       "t_boot/device_meta.json")
    pairs["host/meta.json"] = ("j_boot/host/meta.json", "t_boot/host/meta.json")
    jdvo = JDeviceVO(jcfg, jcam, chunk=4)
    jdvo.state = P.jax_state(seed)
    jckpt.save_device_vo(jdvo, tmp_path / "j_dev")
    tdvo = DeviceVO(tcfg, tcam, chunk=4, device="cpu")
    tdvo.state = VOState.from_numpy(seed)
    save_device_vo(tdvo, tmp_path / "t_dev")
    pairs["device_meta.json"] = ("j_dev/device_meta.json", "t_dev/device_meta.json")
    jckpt.save_slam(JSlam(jcfg, jcam), tmp_path / "j_slam")
    save_slam(Slam(tcfg, tcam, device="cpu"), tmp_path / "t_slam")
    pairs["slam_meta.json"] = ("j_slam/slam_meta.json", "t_slam/slam_meta.json")
    for name, (j, t) in pairs.items():
        assert _keys(tmp_path / t) == _keys(tmp_path / j), name


def jax_state_arrays(path, jcfg) -> dict:
    """The JAX package's ``state`` Orbax checkpoint as the port's flat
    ``VOState`` names (``VOState.to_numpy``)."""
    import orbax.checkpoint as ocp

    target = jax.tree.map(np.asarray, jckpt._state_dict(JVOState.empty(jcfg)))
    st = ocp.StandardCheckpointer().restore(path / "state", target)
    out = {f"map.{k}": v for k, v in st["map"].items()}
    out.update({f"win_{k}": v for k, v in st["win"].items()})
    for group in ("win_feats", "kf_ring"):
        out.update({f"{group}.{k}": v for k, v in st[group].items()})
    out.update(R=st["pose"]["R"], t=st["pose"]["t"], vel_R=st["vel"]["R"],
               vel_t=st["vel"]["t"], **st["scalars"])
    return {k: np.asarray(v) for k, v in out.items()}


def test_jax_checkpoint_tracks_in_the_port(tmp_path):
    """The JAX DeviceVO tracks frames 1-4 from a seeded map and saves; the
    port restores that checkpoint (its arrays read through Orbax) and both
    track frames 5-12 with the JAX draws."""
    jcfg, tcfg = P.configs()
    jcam, tcam = P.cameras()
    seq, poses, _ = P.orbit(13)
    jvo = JDeviceVO(jcfg, jcam, chunk=4)
    jvo.state = P.jax_state(_seed(jcfg, tcfg))
    for f in seq[1:5]:
        jvo.process(jnp.asarray(f))
    jckpt.save_device_vo(jvo, tmp_path / "ck")
    np.savez(tmp_path / "ck" / "state.npz", **jax_state_arrays(tmp_path / "ck", jcfg))
    tvo = DeviceVO(tcfg, tcam, chunk=4, device="cpu", sampler=P.JaxSampler())
    restore_device_vo(tvo, tmp_path / "ck")
    assert len(tvo.trajectory) == len(tvo.stats) == 4
    for f in seq[5:]:
        jvo.process(jnp.asarray(f))
        tvo.process(f)
    jvo.flush()
    tvo.flush()
    sj, st = jvo.stats[4:], tvo.stats[4:]
    assert len(st) == len(sj) == 8 and all(s.tracking for s in sj)
    assert [s.tracking for s in st] == [s.tracking for s in sj]
    assert [s.num_features for s in st] == [s.num_features for s in sj]
    for name in ("num_matches", "num_inliers"):
        np.testing.assert_allclose([getattr(s, name) for s in st],
                                   [getattr(s, name) for s in sj], rtol=0.02, err_msg=name)
    dc = np.linalg.norm(tvo.positions[4:] - jvo.positions[4:], axis=1)
    assert dc.max() < 2e-3, dc
    dR = [Rt.T @ Rj for (Rt, _), (Rj, _) in zip(tvo.trajectory[4:], jvo.trajectory[4:])]
    angle = [np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)) for r in dR]
    assert max(angle) < 1e-3, angle
