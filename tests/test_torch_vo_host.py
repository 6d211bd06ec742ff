"""The port's host-stepped ``VisualOdometry`` after its bootstrap against
the JAX package's, with the JAX package's draws injected
(``torch_parity.JaxSampler``): over the 160x120 orbit's 22 frames with
keyframes on and a relocalization forced at frame 14, the same tracking
and keyframe flags and ``kf_frames_log``, camera centres within 2e-3,
landmark counts within 2%.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests import torch_parity as P
from tinyslam_tpu.models.vo import VisualOdometry as JVisualOdometry
from tinyslam_tpu_torch.models.vo import VisualOdometry

_FRAMES, _POSES, _ROOM = P.orbit(22)
RELOC_FRAME = 14


def _track(vo, frames, reloc_at=None):
    for i, f in enumerate(frames):
        if i == reloc_at:
            vo.force_reloc = True
        vo.process(f)
    return vo


@pytest.fixture(scope="module")
def vo_runs():
    jcfg, tcfg = P.configs(keyframes=True)
    jcam, tcam = P.cameras()
    sampler = P.JaxSampler()
    return {"jax": _track(JVisualOdometry(jcfg, jcam), _FRAMES, RELOC_FRAME),
            "torch": _track(VisualOdometry(tcfg, tcam, device="cpu", sampler=sampler),
                            _FRAMES, RELOC_FRAME),
            "sampler": sampler}


def _flags(vo):
    return np.array([(s.tracking, s.is_keyframe) for s in vo.stats])


def test_visual_odometry_tracking_matches_jax(vo_runs):
    vj, vt = vo_runs["jax"], vo_runs["torch"]
    assert len(vt.stats) == len(vj.stats) == len(_FRAMES)
    np.testing.assert_array_equal(_flags(vt), _flags(vj))
    boot = vt.kf_frames_log[1]
    assert _flags(vt)[boot:, 0].all()
    assert vt.kf_frames_log == vj.kf_frames_log and vt.num_keyframes >= 5
    # The forced relocalization drew under ("host_reloc", frame).
    assert ("host_reloc", RELOC_FRAME) in vo_runs["sampler"].calls
    lm_t = np.array([s.num_landmarks for s in vt.stats], float)
    lm_j = np.array([s.num_landmarks for s in vj.stats], float)
    np.testing.assert_allclose(lm_t, lm_j, rtol=0.02)
    dc = np.linalg.norm(vt.positions - vj.positions, axis=1)
    assert dc.max() < 2e-3, dc
    np.testing.assert_array_equal(vt.win_kf_id, vj.win_kf_id)
