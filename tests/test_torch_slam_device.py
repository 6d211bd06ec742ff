"""The whole slice: the port's ``DeviceSlam`` against the JAX package's on
an out-and-back of the 160x120 orbit (frames 0-21, then 20-0: the return
leg revisits the mapped scene), with the JAX package's draws injected
(``torch_parity.JaxSampler``) and ``loop_min_gap`` 3, so that loop
closures are accepted within 43 frames.

Tolerances: the same keyframes (count and ``kf_frame_of``), the same edges
(i, j equal; s and w within 1e-3), the same ``loop_log`` decisions with
at least one accepted closure, the corrected camera centres within 2e-3
and the Sim(3)-aligned ATE within 1e-3.  The asynchronous back-end
accepts the same number of closures.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tests import torch_parity as P
from tinyslam_tpu.models.slam import DeviceSlam as JDeviceSlam
from tinyslam_tpu.utils import evaluation as jev
from tinyslam_tpu_torch.models.slam import DeviceSlam
from tinyslam_tpu_torch.utils import evaluation as tev

_FRAMES, _POSES, _ROOM = P.orbit(22)
FRAMES = _FRAMES + _FRAMES[-2::-1]
POSES = _POSES + _POSES[-2::-1]
LOOP_MIN_GAP = 3


def _configs():
    return tuple(dataclasses.replace(c, pose_graph=dataclasses.replace(
        c.pose_graph, loop_min_gap=LOOP_MIN_GAP)) for c in P.configs(keyframes=True))


def _run(slam):
    for f in FRAMES:
        slam.process_frame(f)
    slam.finalize()
    return slam


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = _configs()
    jcam, tcam = P.cameras()
    sampler = P.JaxSampler()
    return {"jax": _run(JDeviceSlam(jcfg, jcam, chunk=4)),
            "torch": _run(DeviceSlam(tcfg, tcam, chunk=4, device="cpu", sampler=sampler)),
            "sampler": sampler}


def test_device_slam_keyframes_and_edges_match_jax(runs):
    sj, st = runs["jax"], runs["torch"]
    n = len(st.kf_R)
    assert n == len(sj.kf_R) == st.vo.num_keyframes == len(st.kf_store) >= 10
    assert st.kf_frame_of == sj.kf_frame_of
    assert [(e[0], e[1]) for e in st.edges] == [(e[0], e[1]) for e in sj.edges]
    for et, ej in zip(st.edges, sj.edges):
        assert 0 <= et[0] < n and 0 <= et[1] < n and et[4] > 0 and et[5] > 0
        np.testing.assert_allclose(et[4:], ej[4:], rtol=0, atol=1e-3)


def test_device_slam_loop_decisions_match_jax(runs):
    sj, st = runs["jax"], runs["torch"]
    keys = ("kf", "old", "n_appear", "accepted")
    assert [tuple(r[k] for k in keys) for r in st.loop_log] == \
        [tuple(r[k] for k in keys) for r in sj.loop_log]
    assert st.num_loop_closures == sj.num_loop_closures >= 1
    # Each candidate drew under its key ("loop", kf * 131 + old); a probe
    # stops logging at its first accepted candidate.
    probes = {c[1] for c in runs["sampler"].calls if c[0] == "loop"}
    assert {r["kf"] * 131 + r["old"] for r in st.loop_log} <= probes


def test_device_slam_trajectory_matches_jax(runs):
    sj, st = runs["jax"], runs["torch"]
    pj, pt = sj.positions, st.positions
    assert pt.shape == pj.shape == (len(FRAMES), 3)
    dc = np.linalg.norm(pt - pj, axis=1)
    assert dc.max() < 2e-3, dc
    first = next(i for i, s in enumerate(st.vo.stats) if s.tracking)
    gt = np.stack([-R.T @ t for R, t in POSES])
    assert tev.ate_rmse(pt[first:], gt[first:]) == pytest.approx(
        jev.ate_rmse(pj[first:], gt[first:]), abs=1e-3)
    # The correction moved the dense trajectory.
    assert np.abs(st.raw_positions - pt).max() > 1e-4


def test_device_slam_async_backend_closes_the_same_loops(runs):
    _, tcfg = _configs()
    _, tcam = P.cameras()
    slam = DeviceSlam(tcfg, tcam, chunk=4, async_backend=True, device="cpu",
                      sampler=P.JaxSampler())
    try:
        _run(slam)
        assert slam.num_loop_closures == runs["torch"].num_loop_closures
        assert slam._worker.restarts == 0
        n = len(slam.kf_R)
        assert n == slam.vo.num_keyframes == len(slam.kf_store)
    finally:
        slam.close()
