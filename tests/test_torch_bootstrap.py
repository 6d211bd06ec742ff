"""The port's bootstrap phase, ``DeviceVO`` from frame 0 and the submap
reboot against the JAX package's, with the JAX package's random draws
injected (``torch_parity.JaxSampler``).

Tolerances.  The bootstrap (``VisualOdometry``, frames 0-6 of the orbit;
the reference's attempts at frames 3-5 fail and frame 6 succeeds): the
same bootstrap frame, model and landmark count, the same map slots and
descriptors, landmarks within 2e-3 and window poses within 1e-4 in the
bootstrap's units (its scale is 2 / median depth, so float differences in
X rescale the whole map: the scale itself is held at rtol 1e-3).
``DeviceVO`` from frame 0 over 22 frames: the same tracking and keyframe
flags, camera centres within 2e-3, landmark counts within 2%.  The reboot
(``reloc_max_frames=2``, blank frames): the same ``submap_events`` frame
and base (atol 1e-4), tracking resuming at the same frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests import torch_parity as P
from tinyslam_tpu.models.vo_device import DeviceVO as JDeviceVO
from tinyslam_tpu.utils import evaluation as jev
from tinyslam_tpu_torch.models.vo_device import DeviceVO
from tinyslam_tpu_torch.utils import evaluation as tev

N_FRAMES = 22
BOOTSTRAP_FRAME = 6
_FRAMES, _POSES, _ROOM = P.orbit(N_FRAMES)


def _run(vo, frames):
    for f in frames:
        vo.process(f)
    vo.flush()
    return vo


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = P.configs(keyframes=True)
    jcam, tcam = P.cameras()
    sampler = P.JaxSampler()
    return {"jax": _run(JDeviceVO(jcfg, jcam, chunk=4), _FRAMES),
            "torch": _run(DeviceVO(tcfg, tcam, chunk=4, device="cpu", sampler=sampler), _FRAMES),
            "sampler": sampler}


def _flags(vo):
    return np.array([(s.tracking, s.is_keyframe) for s in vo.stats])


def test_bootstrap_phase_matches_visual_odometry(runs):
    hj, ht = runs["jax"]._host, runs["torch"]._host
    assert hj.initialized and ht.initialized
    assert runs["torch"].host_frames == runs["jax"].host_frames == BOOTSTRAP_FRAME + 1
    # Attempts at frames 3-6 drew E and H samples in the reference's order.
    assert runs["sampler"].calls[:8] == [("two_view", f, m) for f in (3, 4, 5, 6)
                                        for m in ("E", "H")]
    assert ht.num_keyframes == hj.num_keyframes == 2
    assert ht.kf_frames_log == hj.kf_frames_log == [0, BOOTSTRAP_FRAME]
    np.testing.assert_array_equal(ht.win_valid, hj.win_valid)
    np.testing.assert_array_equal(ht.win_kf_id, hj.win_kf_id)
    valid = ht.map.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(hj.map.valid))
    n = int(valid.sum())
    assert n == int(np.asarray(hj.map.valid).sum()) and n >= 50
    np.testing.assert_array_equal(ht.map.desc.numpy().view(np.uint32), np.asarray(hj.map.desc))
    for name in ("anchor_kf", "obs_count", "last_seen"):
        np.testing.assert_array_equal(getattr(ht.map, name).numpy(),
                                      np.asarray(getattr(hj.map, name)), err_msg=name)
    np.testing.assert_array_equal(ht.win_mask.numpy(), np.asarray(hj.win_mask))
    np.testing.assert_allclose(ht.map.X.numpy()[valid], np.asarray(hj.map.X)[valid],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(ht.win_R.numpy(), np.asarray(hj.win_R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ht.win_t.numpy(), np.asarray(hj.win_t), rtol=0, atol=1e-4)
    # The scale: median landmark depth 2 in both.
    np.testing.assert_allclose(np.linalg.norm(ht.win_t.numpy()[1]),
                               np.linalg.norm(np.asarray(hj.win_t)[1]), rtol=1e-3)
    assert abs(np.median(ht.map.X.numpy()[valid][:, 2]) - 2.0) < 0.1


def test_device_vo_from_frame_0_matches_jax(runs):
    vj, vt = runs["jax"], runs["torch"]
    assert vt.initialized and vt.state.device == torch.device("cpu")
    assert len(vt.stats) == len(vj.stats) == N_FRAMES
    np.testing.assert_array_equal(_flags(vt), _flags(vj))
    assert _flags(vt)[BOOTSTRAP_FRAME:, 0].all()
    assert vt.num_keyframes == vj.num_keyframes >= 5
    lm_t = np.array([s.num_landmarks for s in vt.stats], float)
    lm_j = np.array([s.num_landmarks for s in vj.stats], float)
    np.testing.assert_allclose(lm_t, lm_j, rtol=0.02)
    dc = np.linalg.norm(vt.positions - vj.positions, axis=1)
    assert dc.max() < 2e-3, dc
    # The Sim(3)-aligned error against the orbit is the reference's.
    gt = np.stack([-R.T @ t for R, t in _POSES])[BOOTSTRAP_FRAME:]
    assert tev.ate_rmse(vt.positions[BOOTSTRAP_FRAME:], gt) == pytest.approx(
        jev.ate_rmse(vj.positions[BOOTSTRAP_FRAME:], gt), abs=1e-3)


def test_umeyama_and_ate_match_jax():
    rng = np.random.default_rng(4)
    gt = rng.normal(0, 1, (50, 3))
    R = np.linalg.qr(rng.normal(0, 1, (3, 3)))[0]
    R *= np.linalg.det(R)
    est = 0.37 * (gt @ R.T) + [0.5, -1.0, 2.0] + rng.normal(0, 0.01, gt.shape)
    for a, b in zip(tev.umeyama_alignment(est, gt), jev.umeyama_alignment(est, gt)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for kw in ({}, {"with_scale": False}, {"align": False}):
        assert tev.ate_rmse(est, gt, **kw) == pytest.approx(jev.ate_rmse(est, gt, **kw),
                                                            rel=1e-12)
    with pytest.raises(ValueError):
        tev.ate_rmse(est[:3], gt)


@pytest.fixture(scope="module")
def reboot_runs():
    """Orbit frames 0-11, three blank frames, then orbit frames 0-11
    again: with reloc_max_frames=2 the chunk that ends in two lost frames
    reboots, and the host phase bootstraps a second submap from the start
    of the orbit.  (Where the camera moved on instead, the second bootstrap
    at 160x120 falls on a knife edge: the attempts' cheirality counts sit
    at the 50-point gate, and float rounding decides.)"""
    jcfg, tcfg = (dataclasses.replace(c, vo=dataclasses.replace(c.vo, reloc_max_frames=2))
                  for c in P.configs(keyframes=True))
    jcam, tcam = P.cameras()
    blank = np.zeros_like(_FRAMES[0])
    frames = _FRAMES[:12] + [blank] * 3 + _FRAMES[:12]
    return {"jax": _run(JDeviceVO(jcfg, jcam, chunk=4), frames),
            "torch": _run(DeviceVO(tcfg, tcam, chunk=4, device="cpu",
                                    sampler=P.JaxSampler()), frames)}


def test_reboot_matches_jax(reboot_runs):
    vj, vt = reboot_runs["jax"], reboot_runs["torch"]
    assert vt.num_reboots == vj.num_reboots == 1
    (ej,), (et,) = vj.submap_events, vt.submap_events
    assert et["frame"] == ej["frame"]
    for a, b in zip(et["base"], ej["base"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    # The base is the last tracked pose.
    last = max(i for i, s in enumerate(vt.stats[:et["frame"] + 1]) if s.tracking)
    np.testing.assert_allclose(et["base"][0], vt.trajectory[last][0], atol=1e-6)
    ft, fj = _flags(vt), _flags(vj)
    np.testing.assert_array_equal(ft, fj)
    resumed = et["frame"] + 1 + np.flatnonzero(ft[et["frame"] + 1:, 0])
    assert len(resumed) > 0 and vt.initialized
    assert vt.host_frames == vj.host_frames
    dc = np.linalg.norm(vt.positions - vj.positions, axis=1)
    assert dc.max() < 2e-3, dc
