"""The port's loop-closure layer against the JAX package's, function by
function: the keyframe signature and ingest, landmark re-anchoring, the
loop probe (with the JAX package's draws, ``torch_parity.JaxSampler``),
the padded graph solve, ``_extend_solution`` and ``corrected_trajectory``;
and the back-end worker and its watchdog.

Tolerances: integers equal; the probe's floats (RMSE, pose, scale
estimates) within 2e-3; the ingest's snapshot and the re-anchored points
within 1e-5; the graph solve's R, t, s within 1e-4; the pure bookkeeping
(``_extend_solution``, ``corrected_trajectory``) within 1e-5.  The inputs
are the 160x120 set-up of ``torch_parity``: the orbit's frame 0 features
at their ray-cast 3D points make the map, later frames the keyframes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu.geometry import se3 as jse3, sim3 as jsim3
from tinyslam_tpu.models import slam as jslam
from tinyslam_tpu.models.vo import MapState as JMapState
from tinyslam_tpu_torch.backend import pose_graph as tpg
from tinyslam_tpu_torch.frontend.orb import extract_features
from tinyslam_tpu_torch.models import slam as tslam
from tinyslam_tpu_torch.models.vo import MapState
from tinyslam_tpu_torch.parallel.pipeline import AsyncWorker
from tinyslam_tpu_torch.types import Features
from tinyslam_tpu_torch.utils.faults import Watchdog

_FRAMES, _POSES, _ROOM = P.orbit(9)
OLD, CUR = (0, 2), 8          # the candidate keyframes' frames, the current one


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _feats(i: int) -> dict:
    _, tcfg = P.configs()
    return extract_features(T(_FRAMES[i]), tcfg.frontend.threshold, tcfg.frontend).to_numpy()


@pytest.fixture(scope="module")
def scene():
    """Features of the probe's frames (numpy) and a map: frame 0's features
    at their ray-cast points, anchored at keyframes 0-5."""
    _, tcfg = P.configs()
    feats = {i: _feats(i) for i in (*OLD, CUR)}
    state = P.seeded_state(tcfg, feats[0], _ROOM, _POSES[0])
    m = {k[4:]: v for k, v in state.items() if k.startswith("map.")}
    rng = np.random.default_rng(0)
    m["anchor_kf"] = np.where(m["valid"], rng.integers(0, 6, m["valid"].shape), -1).astype(
        np.int32)
    return feats, m


def _maps(m: dict):
    return (JMapState(**{k: jnp.asarray(v) for k, v in m.items()}),
            MapState.from_numpy(m))


def _pose(i: int, drift: float = 0.0):
    """Orbit frame i's pose, its translation scaled by 1 + drift (a map
    whose scale drifted) and its rotation turned by drift / 10 rad."""
    R, t = (np.asarray(a, np.float32) for a in _POSES[i])
    dR = np.asarray(jse3.so3_exp(jnp.asarray([0.0, drift / 10, 0.0], jnp.float32)))
    return (dR @ R).astype(np.float32), (t * (1.0 + drift)).astype(np.float32)


def test_kf_signature_matches_jax(scene):
    feats, _ = scene
    f = feats[CUR]
    got = tslam._kf_signature(Features.from_numpy(f)).numpy()
    want = np.asarray(jslam._kf_signature(P.jax_features(f)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (256,) and np.abs(got).max() <= 1.0


def test_kf_ingest_matches_jax(scene):
    feats, m = scene
    jcfg, _ = P.configs()
    jcam, tcam = P.cameras()
    jmap, tmap = _maps(m)
    R, t = _pose(OLD[1])
    kw = dict(max_distance=jcfg.matcher.max_distance, ratio=jcfg.matcher.ratio)
    Xj, okj, sigj = (np.asarray(a) for a in jslam._kf_ingest(
        jcam, P.jax_features(feats[OLD[1]]), jmap, jnp.asarray(R), jnp.asarray(t), **kw))
    Xt, okt, sigt = (a.numpy() for a in tslam._kf_ingest(
        tcam, Features.from_numpy(feats[OLD[1]]), tmap, T(R), T(t), **kw))
    np.testing.assert_array_equal(okt, okj)
    assert okt.sum() >= 50
    np.testing.assert_allclose(Xt[okt], Xj[okj], rtol=0, atol=1e-5)
    np.testing.assert_allclose(sigt, sigj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scaled", [False, True], ids=["se3", "sim3"])
def test_reanchor_landmarks_matches_jax(scaled):
    rng = np.random.default_rng(1)
    K, M = 6, 300
    xi = rng.normal(0, 0.3, (K, 7)).astype(np.float32)
    R_old, t_old, _ = (np.asarray(a) for a in jsim3.sim3_exp(jnp.asarray(xi * [1, 1, 1, 1, 1,
                                                                              1, 0])))
    R_new, t_new, s_new = (np.asarray(a) for a in jsim3.sim3_exp(jnp.asarray(
        xi + rng.normal(0, 0.05, (K, 7)).astype(np.float32))))
    X = rng.normal(0, 2, (M, 3)).astype(np.float32)
    anchor = rng.integers(-1, K + 2, M).astype(np.int32)      # clipped at both ends
    valid = rng.random(M) > 0.2
    args = (X, anchor, valid, R_old, t_old, R_new, t_new) + ((s_new,) if scaled else ())
    want = np.asarray(jslam._reanchor_landmarks(*(jnp.asarray(a) for a in args)))
    got = tslam._reanchor_landmarks(*(T(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[~valid], X[~valid])


def _probe_against_jax(scene, drift, offset, scalars):
    """The probe of ``test_loop_probe_matches_jax`` in both packages, the
    port's ids and offset as ints or (``scalars``) as tensors, as a captured
    probe takes them from its static buffers."""
    feats, m = scene
    jcfg, tcfg = P.configs()
    jcam, tcam = P.cameras()
    jmap, tmap = _maps(m)
    mc, vo = jcfg.matcher, jcfg.vo
    snaps = [jslam._kf_ingest(jcam, P.jax_features(feats[f]), jmap,
                              *(jnp.asarray(a) for a in _pose(f)),
                              max_distance=mc.max_distance, ratio=mc.ratio) for f in OLD]
    old_X = np.stack([np.asarray(s[0]) for s in snaps])
    old_ok = np.stack([np.asarray(s[1]) for s in snaps])
    R_cur, t_cur = _pose(CUR, drift)
    old_ids, kf_id = [0, 1], 6
    old_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[P.jax_features(feats[f]) for f in OLD])
    want = jslam._loop_probe(
        jcam, P.jax_features(feats[CUR]), old_j, jnp.asarray(old_ids, jnp.int32),
        jnp.asarray(old_X), jnp.asarray(old_ok), jmap, jnp.int32(offset), jnp.asarray(R_cur),
        jnp.asarray(t_cur), jnp.int32(kf_id), max_distance=mc.max_distance, ratio=mc.ratio,
        num_hypotheses=vo.reloc_hypotheses, pnp_iters=vo.pnp_iters, inlier_px=vo.pnp_inlier_px)
    want = {k: np.asarray(v) for k, v in want.items()}
    sampler = P.JaxSampler()
    old_t = Features.from_numpy({k: np.stack([feats[f][k] for f in OLD])
                                 for k in P.FEATURE_FIELDS})
    ids = ((torch.tensor(old_ids), torch.tensor(offset), torch.tensor(kf_id)) if scalars
           else (old_ids, offset, kf_id))
    rows = tslam._loop_probe(
        tcam, Features.from_numpy(feats[CUR]), old_t, ids[0], T(old_X), T(old_ok), tmap,
        ids[1], T(R_cur), T(t_cur), ids[2],
        sampler, max_distance=mc.max_distance, ratio=mc.ratio,
        num_hypotheses=vo.reloc_hypotheses, pnp_iters=vo.pnp_iters, inlier_px=vo.pnp_inlier_px)
    got = tslam.unpack_probe(rows.numpy())
    assert sampler.calls == [("loop", kf_id * 131 + o) for o in old_ids]
    assert set(got) == set(want)
    for k in ("n_appear", "n_chain", "num_inliers", "n_scale_pairs", "n_scale_old",
              "n_scale_new"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (want["num_inliers"] >= 20).all() and (want["n_scale_new"] > 0).all()
    for k in ("rmse", "R", "t", "s_e", "s_e_med"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-3, err_msg=k)
    return rows


@pytest.mark.parametrize("drift,offset", [(0.0, 0), (0.1, 1)], ids=["no drift", "drifted"])
def test_loop_probe_matches_jax(scene, drift, offset):
    """Two candidates (keyframes at frames 0 and 2, their snapshots ingested
    at their own poses) probed from frame 8, at its pose or at a pose that
    drifted (10% in translation, 0.01 rad), with a submap anchor offset of 0
    or 1: the appearance, chain, inlier and scale-pair counts equal, the
    old-gauge pose and the scale estimates within 2e-3."""
    _probe_against_jax(scene, drift, offset, scalars=False)


@pytest.mark.parametrize("drift,offset", [(0.0, 0), (0.1, 1)], ids=["no drift", "drifted"])
def test_loop_probe_with_device_scalars_matches_jax(scene, drift, offset):
    """The probe with its keyframe id, candidate ids and anchor offset as
    tensors, as the captured probe reads them on the card: the JAX package's
    draws under the same keys, and ``test_loop_probe_matches_jax``'s
    tolerances; and bit for bit the probe with ints under the port's own
    keyed draws (``Sampler``), through ``loop_probe``, the stage."""
    _probe_against_jax(scene, drift, offset, scalars=True)
    feats, m = scene
    _, tcfg = P.configs()
    _, tcam = P.cameras()
    old_t = Features.from_numpy({k: np.stack([feats[f][k] for f in OLD])
                                 for k in P.FEATURE_FIELDS})
    snaps = [tslam.unpack_ingest(tslam.kf_ingest(tcam, tcfg, Features.from_numpy(feats[f]),
                                                 MapState.from_numpy(m), *_pose(f)))
             for f in OLD]
    old_X, old_ok = np.stack([x for x, _, _ in snaps]), np.stack([o for _, o, _ in snaps])
    R_cur, t_cur = _pose(CUR, drift)
    args = (tcam, Features.from_numpy(feats[CUR]), old_t)
    tail = dict(max_distance=tcfg.matcher.max_distance, ratio=tcfg.matcher.ratio,
                num_hypotheses=tcfg.vo.reloc_hypotheses, pnp_iters=tcfg.vo.pnp_iters,
                inlier_px=tcfg.vo.pnp_inlier_px)
    by_scalars = tslam._loop_probe(
        *args, torch.tensor([0, 1]), T(old_X), T(old_ok), MapState.from_numpy(m),
        torch.tensor(offset), T(R_cur), T(t_cur), torch.tensor(6), tslam.Sampler(3), **tail)
    by_stage = tslam.loop_probe(tcam, tcfg, Features.from_numpy(feats[CUR]), old_t, [0, 1],
                                old_X, old_ok, MapState.from_numpy(m), offset, R_cur, t_cur, 6,
                                tslam.Sampler(3))
    assert np.array_equal(by_scalars.numpy(), by_stage, equal_nan=True)


def _snapshot(n: int, n_loops: int, seed: int = 0):
    """A keyframe chain of n poses (odometry edges measured with noise) and
    n_loops loop edges, one of them at scale 0.9: the (R, t, edges)
    snapshot ``_optimize_graph`` hands to the solve."""
    rng = np.random.default_rng(seed)
    J = lambda arrs: [jnp.asarray(v) for v in arrs]   # noqa: E731
    xi = np.zeros((n, 7), np.float32)
    ang = np.linspace(0, 1.5 * np.pi, n)
    xi[:, 0], xi[:, 2], xi[:, 4] = 2 * np.cos(ang), 2 * np.sin(ang), ang
    gt = [np.asarray(a) for a in jsim3.sim3_exp(jnp.asarray(xi))]

    def rel(i, j):
        return jsim3.sim3_compose(*J([g[j] for g in gt]),
                                  *jsim3.sim3_inverse(*J([g[i] for g in gt])))

    def noisy(S):
        d = jsim3.sim3_exp(jnp.asarray(rng.normal(0, 0.01, 7).astype(np.float32)
                                       * [1, 1, 1, 1, 1, 1, 0]))
        return [np.asarray(a) for a in jsim3.sim3_compose(*d, *S)]

    edges, R, t = [], [gt[0][0]], [gt[1][0]]
    for k in range(n - 1):
        Re, te, _ = noisy(rel(k, k + 1))
        edges.append((k, k + 1, Re, te, 1.0, 1.0))
        Rk, tk = (np.asarray(a) for a in jse3.se3_compose(jnp.asarray(Re), jnp.asarray(te),
                                                        jnp.asarray(R[-1]), jnp.asarray(t[-1])))
        R.append(Rk)
        t.append(tk)
    loops = [(i, j) for i in range(n) for j in range(n - 1, i + 4, -1)][:n_loops]
    for q, (i, j) in enumerate(loops):
        Re, te, se = noisy(rel(i, j))
        s = 0.9 if q == 0 else 1.0
        edges.append((i, j, Re, te * s, float(se) * s, 5.0))
    return np.stack(R).astype(np.float32), np.stack(t).astype(np.float32), edges


@pytest.mark.parametrize("sim3", [True, False], ids=["sim3", "se3"])
@pytest.mark.parametrize("n,caps,pads", [(33, {}, (64, 128)),
                                         (20, dict(max_nodes=24, max_edges=100), (24, 100))],
                         ids=["past 32 nodes", "capped"])
def test_solve_graph_matches_jax(sim3, n, caps, pads, monkeypatch):
    """Nodes pad to multiples of 32 and edges to multiples of 128, capped
    at ``max_nodes``/``max_edges``, in both packages."""
    jcfg, tcfg = P.configs()
    jcfg, tcfg = (dataclasses.replace(c, pose_graph=dataclasses.replace(
        c.pose_graph, sim3=sim3, **caps)) for c in (jcfg, tcfg))
    snap = _snapshot(n, 2)
    shapes = []
    solver = "optimize_pose_graph_sim3" if sim3 else "optimize_pose_graph"
    real = getattr(tslam, solver)

    def spy(R, t, *a, **kw):
        shapes.append((R.shape[0], kw["edge_valid"].shape[0]))
        return real(R, t, *a, **kw)

    monkeypatch.setattr(tslam, solver, spy)
    got = tslam.unpack_solve(tslam.solve_graph(tcfg, snap, "cpu"))
    want = jslam.Slam._solve_graph(types.SimpleNamespace(cfg=jcfg), snap)
    assert shapes == [pads]
    for g, w, name in zip(got, want, "Rts"):
        assert g.shape == np.asarray(w).shape and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4, err_msg=name)
    if not sim3:
        np.testing.assert_array_equal(got[2], 1.0)
    else:       # the scale loop edge moved the scales off 1
        assert np.abs(got[2] - 1).max() > 0.02


@pytest.mark.parametrize("sim3", [True, False], ids=["sim3", "se3"])
@pytest.mark.parametrize("n,n_loops,pads", [(33, 97, (64, 256)), (32, 96, (32, 128))],
                         ids=["just over 32 and 128", "at 32 and 128"])
def test_solve_rows_at_padded_shapes_matches_jax(sim3, n, n_loops, pads):
    """The captured solve's body (``_solve_rows`` over ``padded_graph``'s
    static-shape tables) against the JAX package's ``_solve_graph``, with n
    nodes and E edges just over a multiple of the padding and exactly at
    one: the padded shapes, and R, t, s within
    ``test_solve_graph_matches_jax``'s 1e-4."""
    jcfg, tcfg = P.configs()
    jcfg, tcfg = (dataclasses.replace(c, pose_graph=dataclasses.replace(c.pose_graph, sim3=sim3))
                  for c in (jcfg, tcfg))
    snap = _snapshot(n, n_loops)
    tables, n_got = tslam.padded_graph(tcfg.pose_graph, snap)
    assert n_got == n and (len(tables["R"]), len(tables["edge_i"])) == pads
    assert tables["node_valid"].sum() == n and tables["edge_valid"].sum() == n - 1 + n_loops
    rows = tslam._solve_rows(sim3, tcfg.pose_graph.gn_iters,
                             {k: torch.from_numpy(v) for k, v in tables.items()}).numpy()
    assert rows.shape == (pads[0], 13) and rows.dtype == np.float32
    want = jslam.Slam._solve_graph(types.SimpleNamespace(cfg=jcfg), snap)
    got = tslam.unpack_solve(rows[:n])
    for g, w, name in zip(got, want, "Rts"):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4, err_msg=name)
    # The padded nodes stay where the tables put them.
    np.testing.assert_array_equal(rows[n:, :9], np.tile(np.eye(3, dtype=np.float32).reshape(9),
                                                        (pads[0] - n, 1)))
    assert np.array_equal(rows[n:, 9:], np.concatenate(
        [np.zeros((pads[0] - n, 3)), np.ones((pads[0] - n, 1))], 1))


def test_extend_solution_matches_jax():
    """A solve over the first 5 keyframes, applied when 7 exist: the two
    newer ones ride the newest solved node's similarity correction."""
    R, t, edges = _snapshot(7, 1, seed=2)
    snap = (R[:5], t[:5], edges[:4])
    rng = np.random.default_rng(3)
    dxi = rng.normal(0, 0.05, (5, 7)).astype(np.float32)
    R_sim, t_sim, s_sim = (np.asarray(a) for a in jsim3.sim3_compose(
        *jsim3.sim3_exp(jnp.asarray(dxi)), jnp.asarray(R[:5]), jnp.asarray(t[:5]),
        jnp.ones(5, jnp.float32)))
    kf_R, kf_t = list(R), list(t)
    got = tslam.Slam._extend_solution(snap, (R_sim, t_sim, s_sim), kf_R, kf_t)
    want = jslam.Slam._extend_solution(snap, (R_sim, t_sim, s_sim), kf_R, kf_t)
    assert got[-1] == want[-1] == 7
    for g, w in zip(got[:7], want[:7]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
    for g, w in zip(got[7], want[7]):           # corr (R, t, s)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


def test_corrected_trajectory_matches_jax():
    """Frames ride the correction of their latest keyframe; frames before
    the first keyframe stay as tracked."""
    rng = np.random.default_rng(4)
    xi = rng.normal(0, 0.3, (12, 6)).astype(np.float32)
    traj = [tuple(np.asarray(a) for a in jse3.se3_exp(jnp.asarray(x))) for x in xi]
    kf_frame_of = {0: 2, 1: 5, 2: 9, 3: 40}          # keyframe 3 beyond the trajectory
    dxi = rng.normal(0, 0.05, (4, 6)).astype(np.float32)
    kf = [jse3.se3_compose(*jse3.se3_exp(jnp.asarray(d)), *(jnp.asarray(a)
                                                            for a in traj[f]))
          for d, f in zip(dxi, (2, 5, 9, 11))]
    ns = types.SimpleNamespace(vo=types.SimpleNamespace(trajectory=traj),
                               kf_frame_of=kf_frame_of,
                               kf_R=[np.asarray(k[0]) for k in kf],
                               kf_t=[np.asarray(k[1]) for k in kf])
    got = tslam.Slam.corrected_trajectory(ns)
    want = jslam.Slam.corrected_trajectory(ns)
    assert len(got) == len(want) == 12
    for (Rg, tg), (Rw, tw) in zip(got, want):
        np.testing.assert_allclose(Rg, Rw, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tg, tw, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0][1], traj[0][1])
    np.testing.assert_allclose(got[5][1], ns.kf_t[1], rtol=0, atol=1e-6)


def test_async_worker_latest_wins():
    w = AsyncWorker()
    try:
        done = []

        def slow(tag):
            def fn():
                time.sleep(0.2)
                done.append(tag)
                return tag
            return fn

        w.submit(slow("a"))
        time.sleep(0.05)          # "a" started
        w.submit(slow("b"))
        w.submit(slow("c"))       # replaces "b" before it starts
        assert w.flush() == "c"
        assert "b" not in done
    finally:
        w.close()


def test_async_worker_propagates_errors():
    w = AsyncWorker()
    try:
        def boom():
            raise ValueError("backend failure")

        w.submit(boom)
        with pytest.raises(ValueError, match="backend failure"):
            w.flush()
        w.submit(lambda: "next")          # the worker survives its job's error
        assert w.flush() == "next"
    finally:
        w.close()


def test_watchdog_restarts_dead_and_stuck_workers():
    w = Watchdog(solve_timeout_s=5.0)
    w.submit(lambda: "a")
    assert w.flush() == "a"
    w.worker.close()                      # a crashed back-end thread
    assert not w.worker.alive
    assert w.check() == "restarted-dead" and w.restarts == 1
    assert w.flush() == "a"               # the last job was resubmitted
    w.close()

    w = Watchdog(solve_timeout_s=0.2, resubmit=False)
    release = threading.Event()
    w.submit(lambda: release.wait(10.0))  # a solve past its deadline
    t0 = time.monotonic()
    assert w.flush() is None              # bounded, not blocked
    assert time.monotonic() - t0 < 5.0 and w.restarts == 1
    w.submit(lambda: "ok")
    assert w.flush() == "ok"
    release.set()
    w.close()


def test_watchdog_resubmits_a_stuck_graph_solve(monkeypatch):
    """A real graph solve hangs on the worker inside its Gauss-Newton loop;
    past the deadline the watchdog rebuilds the worker and resubmits it.
    The resubmitted solve runs while the abandoned one is still inside its
    own, and its result is applied as a synchronous solve's would be."""
    _, tcfg = P.configs()
    _, tcam = P.cameras()
    R, t, edges = _snapshot(12, 2)
    want = tslam.unpack_solve(tslam.solve_graph(tcfg, (R, t, edges), "cpu"))
    entered, release = threading.Event(), threading.Event()
    real = tpg.edge_jacobians

    def hang_once(*a, **kw):
        out = real(*a, **kw)
        if not entered.is_set():
            entered.set()
            release.wait(30.0)
        return out

    monkeypatch.setattr(tpg, "edge_jacobians", hang_once)
    slam = tslam.Slam(tcfg, tcam, async_backend=True, solve_timeout_s=0.5, device="cpu")
    applied = []
    real_apply = slam._apply_graph_result
    slam._apply_graph_result = lambda snap, solved: (applied.append(solved),
                                                     real_apply(snap, solved))
    slam.kf_R, slam.kf_t, slam.edges = list(R), list(t), list(edges)
    try:
        slam._optimize_graph()
        stuck = slam._worker.worker
        assert entered.wait(10.0)
        slam.finalize()             # past the deadline: rebuilt, resubmitted
        assert slam._worker.restarts == 1 and not release.is_set()
        # The resubmitted solve is real work, slower under a loaded host than
        # the 0.5 s that caught the hang: give it the time it needs.
        slam._worker.solve_timeout_s = 60.0
        slam.finalize()             # the resubmitted solve's result
        assert len(applied) == 1 and slam._worker.restarts == 1
    finally:
        release.set()
        slam.close()
    # The abandoned solve runs out too, unharmed by the one beside it; only
    # its own worker object, which the Slam no longer reads, holds the result.
    stuck.abandon()
    stuck._thread.join(timeout=120.0)
    assert not stuck.alive
    late = stuck.poll()[1]
    for g, w, a in zip(applied[0], want, late):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-6)
    R_se, t_se = want[0], want[1] / want[2][:, None]
    np.testing.assert_allclose(np.stack(slam.kf_R), R_se, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.stack(slam.kf_t), t_se, rtol=0, atol=1e-5)
