"""The port's host ``Slam`` (loop closure over the host-stepped
``VisualOdometry``) against the JAX package's, with the JAX package's
draws injected (``torch_parity.JaxSampler``), over the out-and-back of
the 160x120 orbit (frames 0-21, then 20-0; ``loop_min_gap`` 3): the same
keyframes and edges (i, j equal; s and w within 1e-3), the same loop
decisions, and tracked camera centres within 2e-3 up to the keyframe
after the second accepted closure (frame 33).  There the host's window
BA, which frees every landmark with two window views, moves one such
landmark of tiny parallax 10 m along its ray in one package and not in
the other (float rounding decides), and the window's poses part by up to
6 mm; the map stays the same set of landmarks.  (The corrected
trajectory rides the keyframe poses that BA refines later, so it is not
compared.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tests import torch_parity as P
from tinyslam_tpu.models.slam import Slam as JSlam
from tinyslam_tpu_torch.models.slam import Slam

_FRAMES, _POSES, _ROOM = P.orbit(22)


def test_host_slam_matches_jax():
    jcfg, tcfg = (dataclasses.replace(c, pose_graph=dataclasses.replace(
        c.pose_graph, loop_min_gap=3)) for c in P.configs(keyframes=True))
    jcam, tcam = P.cameras()
    frames = _FRAMES + _FRAMES[-2::-1]
    sj = JSlam(jcfg, jcam)
    sj.run(frames)
    st = Slam(tcfg, tcam, device="cpu", sampler=P.JaxSampler())
    st.run(frames)
    n = len(st.kf_R)
    assert n == len(sj.kf_R) == st.vo.num_keyframes == len(st.kf_store)
    assert st.kf_frame_of == sj.kf_frame_of
    assert [(e[0], e[1]) for e in st.edges] == [(e[0], e[1]) for e in sj.edges]
    for et, ej in zip(st.edges, sj.edges):
        assert et[4] > 0 and et[5] > 0
        np.testing.assert_allclose(et[4:], ej[4:], rtol=0, atol=1e-3)
    keys = ("kf", "old", "n_appear", "accepted")
    assert [tuple(r[k] for k in keys) for r in st.loop_log] == \
        [tuple(r[k] for k in keys) for r in sj.loop_log]
    assert st.num_loop_closures == sj.num_loop_closures >= 2
    second = [r["kf"] for r in st.loop_log if r["accepted"]][1]
    upto = min(f for k, f in st.kf_frame_of.items() if k > second)
    dc = np.linalg.norm(st.raw_positions - sj.raw_positions, axis=1)
    assert dc[:upto].max() < 2e-3, dc
