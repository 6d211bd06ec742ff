"""The whole slice: the port's ``DeviceSlam`` against the JAX package's on
an out-and-back of the 160x120 orbit (frames 0-21, then 20-0: the return
leg revisits the mapped scene), with the JAX package's draws injected
(``torch_parity.JaxSampler``) and ``loop_min_gap`` 3, so that loop
closures are accepted within 43 frames.

Tolerances: the same keyframes (count and ``kf_frame_of``), the same edges
(i, j equal; s and w within 1e-3), the same ``loop_log`` decisions with
at least one accepted closure, the corrected camera centres within 2e-3
and the Sim(3)-aligned ATE within 1e-3.  The asynchronous back-end
accepts the same number of closures, and a solve that lands after the
last frame rescales each frame tracked while it ran: the distance to its
keyframe the raw one over the solve's scale (within 1e-4 relative), the
live pose moved into the corrected gauge (centre within 1e-4); one that
lags ``solve_lag_frames`` behind is waited for at the next boundary.  A
late correction is counted once on the frames tracked while it ran; a
frame tracked after any correction landed, whose keyframe is older than
the landing, carries that keyframe's correction twice in the synchronous
run, as in the JAX package's (``corrected_trajectory``).
``tools/replay_closures.py``'s path:
the port's run recorded by its ``ClosureRecorder``, every solve replayed
by the JAX package's ``Slam._solve_graph`` and the port's ``solve_graph``
and applied by each package's correction: the port's replay equal to the
run's own solve and correction, the reference's solve within 1e-4 (R, t, s)
and its corrected ATE within 1e-3 m, the same sign of the correction.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

import importlib.util
from pathlib import Path

from tests import torch_parity as P
from tinyslam_tpu.models.slam import DeviceSlam as JDeviceSlam
from tinyslam_tpu.utils import evaluation as jev
from tinyslam_tpu_torch.models.slam import DeviceSlam
from tinyslam_tpu_torch.utils import evaluation as tev

_FRAMES, _POSES, _ROOM = P.orbit(22)
FRAMES = _FRAMES + _FRAMES[-2::-1]
POSES = _POSES + _POSES[-2::-1]
LOOP_MIN_GAP = 3


_SPEC = importlib.util.spec_from_file_location(
    "replay_closures", Path(__file__).resolve().parents[1] / "tools" / "replay_closures.py")
REPLAY = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(REPLAY)


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
    with REPLAY.ClosureRecorder() as rec:
        torch_run = _run(DeviceSlam(tcfg, tcam, chunk=4, device="cpu", sampler=sampler))
    return {"jax": _run(JDeviceSlam(jcfg, jcam, chunk=4)), "torch": torch_run,
            "sampler": sampler, "records": rec.records}


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


def test_async_solve_landing_late_rescales_the_frames_tracked_meanwhile():
    _, tcfg = _configs()
    _, tcam = P.cameras()
    slam = DeviceSlam(tcfg, tcam, chunk=4, async_backend=True, device="cpu",
                      sampler=P.JaxSampler())
    slam.solve_lag_frames = None
    release, seen = threading.Event(), {}
    real_solve, real_late = slam._solve_on_worker, slam._landed_late

    def held(snap):
        release.wait(60.0)
        return real_solve(snap)

    def spy(snap, ext):
        seen["first"] = next(e[1] for e in slam._submits if e[0] is snap)
        seen["raw"] = [(R.copy(), t.copy()) for R, t in slam.vo.trajectory]
        out = real_late(snap, ext)
        seen["W"] = out[1]
        return out

    slam._solve_on_worker, slam._landed_late = held, spy
    try:
        for f in FRAMES:
            slam.process_frame(f)
        release.set()
        slam.finalize()
    finally:
        release.set()
        slam.close()
    first, raw, (R_w, t_w, s_w) = seen["first"], seen["raw"], seen["W"]
    assert slam.num_loop_closures >= 1 and first < len(FRAMES) - 4
    assert abs(float(s_w) - 1.0) > 0.02          # a scale the check can see
    centre = lambda R, t: -R.T @ t                 # noqa: E731
    kf_frames = sorted(slam.kf_frame_of.values())
    pos = slam.positions
    for f in range(first, len(FRAMES)):
        fk = max(g for g in kf_frames if g <= f)
        want = np.linalg.norm(centre(*raw[f]) - centre(*raw[fk])) / float(s_w)
        assert np.linalg.norm(pos[f] - pos[fk]) == pytest.approx(want, rel=1e-4, abs=1e-6)
    R, t = (a.numpy() for a in (slam.vo.state.R, slam.vo.state.t))
    want = R_w.T @ (centre(*raw[-1]) - t_w) / s_w
    np.testing.assert_allclose(centre(R, t), want, rtol=0, atol=1e-4)


def test_async_solve_waited_for_once_it_lags_behind():
    _, tcfg = _configs()
    _, tcam = P.cameras()
    slam = DeviceSlam(tcfg, tcam, chunk=4, async_backend=True, device="cpu",
                      sampler=P.JaxSampler())
    slam.solve_lag_frames = 8
    real_solve, real_optimize = slam._solve_on_worker, slam._optimize_graph
    real_apply, real_flush = slam._apply_graph_result, slam._worker.flush
    submitted, applied, waiting = [], [], threading.Event()

    def slow(snap):         # finishes only once tracking waits for it
        waiting.wait(60.0)
        waiting.clear()
        return real_solve(snap)

    def flush():
        waiting.set()
        return real_flush()

    def optimize():
        submitted.append(len(slam.vo.trajectory))
        real_optimize()

    def apply(*a):
        applied.append(len(slam.vo.trajectory))
        real_apply(*a)

    slam._solve_on_worker, slam._optimize_graph, slam._apply_graph_result = (
        slow, optimize, apply)
    slam._worker.flush = flush
    try:
        for f in FRAMES:
            slam.process_frame(f)
        slam.finalize()
    finally:
        slam.close()
    # Each solve is applied at the first chunk boundary 8 frames after its
    # submit, where tracking waits for it.
    assert len(applied) == len(submitted) >= 1
    assert [a - s for s, a in zip(submitted, applied)
            if a < len(FRAMES)] == [8] * len([a for a in applied if a < len(FRAMES)])
    assert applied[0] < len(FRAMES)


def _landings(slam) -> list:
    """Record, at each applied solve, the frames tracked and the keyframe
    tables right after it."""
    out, real = [], slam._apply_graph_result

    def apply(*a):
        n = len(slam.vo.trajectory)
        real(*a)
        out.append((n, [(R.copy(), t.copy()) for R, t in zip(slam.kf_R, slam.kf_t)]))

    slam._apply_graph_result = apply
    return out


def test_late_correction_counts_once_where_a_landed_one_counts_twice(runs):
    """The second closure's solve held on the worker until the frames after
    its keyframe and before the next one are tracked (the first lands where
    the synchronous run's does), against the synchronous run of the same
    frames.  Held: each of those frames' corrected distance to its keyframe
    is the raw one over the solve's scale, the correction once.  In the
    synchronous run the same frames are tracked after the solve landed, in
    the corrected map, while ``corrected_trajectory`` composes them with
    their keyframe's raw pose from before it: each carries the keyframe's
    correction a second time, by its move at the landing (3.7 cm here), as
    the JAX package's run does (its centres equal the port's,
    ``test_device_slam_trajectory_matches_jax``)."""
    _, tcfg = _configs()
    _, tcam = P.cameras()
    sync = runs["torch"]
    slam = DeviceSlam(tcfg, tcam, chunk=4, async_backend=True, device="cpu",
                      sampler=P.JaxSampler())
    slam.solve_lag_frames = 0                  # the first solve lands at once
    release, seen, submits = threading.Event(), {}, []
    real_solve, real_late, real_optimize = (slam._solve_on_worker, slam._landed_late,
                                            slam._optimize_graph)

    def optimize():
        submits.append(len(slam.vo.trajectory))
        if len(submits) == 2:
            slam.solve_lag_frames = None
        real_optimize()

    def held(snap):
        if len(submits) == 2:
            release.wait(60.0)
        return real_solve(snap)

    def spy(snap, ext):
        seen["raw"] = [(R.copy(), t.copy()) for R, t in slam.vo.trajectory]
        out = real_late(snap, ext)
        seen["W"] = out[1]
        return out

    slam._solve_on_worker, slam._landed_late, slam._optimize_graph = held, spy, optimize
    # The synchronous run again, recording its landings.
    again = DeviceSlam(tcfg, tcam, chunk=4, device="cpu", sampler=P.JaxSampler())
    landed = _landings(again)
    kf_frames = sorted(sync.kf_frame_of.values())
    try:
        for f in FRAMES:
            slam.process_frame(f)
            again.process_frame(f)
            if len(submits) == 2 and len(slam.vo.trajectory) > min(
                    g for g in kf_frames if g >= submits[1]):
                release.set()
        release.set()
        slam.finalize()
        again.finalize()
    finally:
        release.set()
        slam.close()
    assert np.array_equal(again.positions, sync.positions)
    assert len(submits) == 2 and [n for n, _ in landed][0] == submits[0]
    # The frames between the second closure's keyframe and the next one.
    n2, tables = landed[1]
    fk = max(g for g in kf_frames if g < n2)
    k = kf_frames.index(fk)
    frames = range(n2, min(g for g in kf_frames if g >= n2))
    assert submits[1] == n2 and len(frames) >= 2
    centre = lambda R, t: -R.T @ t                 # noqa: E731
    raw, s_w = seen["raw"], float(seen["W"][2])
    pos = slam.positions
    for f in frames:
        want = np.linalg.norm(centre(*raw[f]) - centre(*raw[fk])) / s_w
        assert np.linalg.norm(pos[f] - pos[fk]) == pytest.approx(want, rel=1e-4, abs=1e-6)
    traj = sync.vo.trajectory
    moved = np.linalg.norm(centre(*traj[fk]) - centre(*tables[k]))
    assert moved > 0.01
    for f in frames:
        R_rel = traj[f][0] @ tables[k][0].T
        once = centre(R_rel @ sync.kf_R[k], R_rel @ sync.kf_t[k] + traj[f][1]
                      - R_rel @ tables[k][1])
        assert np.linalg.norm(sync.positions[f] - once) == pytest.approx(moved, abs=2e-3)


def test_replay_closures_through_both_packages(runs):
    jcfg, tcfg = _configs()
    gt = np.stack([-R.T @ t for R, t in POSES])
    rows = [REPLAY.replay(rec, gt, jcfg, tcfg) for rec in runs["records"]]
    assert len(rows) == runs["torch"].num_loop_closures >= 1
    for r in rows:
        assert r["solve_diff"]["card-port_cpu"] == {"R": 0.0, "t": 0.0, "s": 0.0}
        assert r["card_reproduced_on_cpu"] == 0.0
        for k in ("R", "t", "s"):
            assert r["solve_diff"]["card-reference"][k] <= 1e-4, r["solve_diff"]
        assert r["ate_card_vs_reference_m"] <= 1e-3, r["ate_sim3_m"]
        assert r["signs_agree"], r["correction"]
