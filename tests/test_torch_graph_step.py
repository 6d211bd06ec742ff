"""The device tracker's decisions as ``device_cond``s and its keyed
relocalization draws, on the CPU, against Python's ``if`` and the JAX
package.

``device_cond`` called eagerly is a Python ``if`` on its predicate; under
``warm`` it runs both branches and returns the true one's result.  The
``"reloc"`` and ``"loop"`` streams of ``Sampler`` are functions of the
seed and the key's number alone, the seed a host int or a device scalar
alike (``Sampler.keyed_on``).  A captured program (the tracker's chunk,
the batched tracker's step, the SLAM layer's stages) is refused off the
card.  ``track_chunk``
with those draws (the port's own, not the JAX package's) holds the JAX ``track_chunk`` at the tolerances of
``tests/test_torch_reloc.py`` (a relocalization: the same tracking flag,
matches and inliers within 2%, camera centres within 2 mm, rotations
within 1e-3 rad) and of ``tests/test_torch_keyframes.py`` (keyframes with
the window BA: per frame ``tracking`` and ``is_keyframe`` equal, landmarks
within 2%, matches and inliers within 3%, centres within 5 mm, rotations
within 2e-3 rad; the final window equal).  Where the tracker relocalizes,
the two packages draw different RANSAC samples; both seat the same pose.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu.frontend.orb import extract_features as jextract
from tinyslam_tpu.geometry import se3 as jse3
from tinyslam_tpu.models.vo_device import track_chunk as jtrack_chunk
from tinyslam_tpu_torch.models.vo_device import (
    SUMMARY_FIELDS,
    BatchGraph,
    ChunkGraph,
    DeviceVO,
    VOState,
    track_chunk,
)
from tinyslam_tpu_torch.utils.cuda_graph import (
    Program, device_cond, device_loop, tree_leaves, warm,
)
from tinyslam_tpu_torch.utils.draws import (
    LOOP_STREAM, RELOC_STREAM, Sampler, keyed_uniform, seed_word,
)

_COL = {name: i for i, name in enumerate(SUMMARY_FIELDS)}
N_TRACKED = 15
_FRAMES, _POSES, _ROOM = P.orbit(N_TRACKED + 1)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------- device_cond ----------------
@pytest.mark.parametrize("pred", [False, True])
def test_device_cond_is_a_python_if(pred):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    calls = []

    def yes(v):
        calls.append("yes")
        return {"v": v * 2, "n": v.sum(dtype=torch.int32)}

    def no(v):
        calls.append("no")
        return {"v": v - 1, "n": torch.zeros((), dtype=torch.int32)}

    got = device_cond(torch.tensor(pred), yes, no, (x,))
    want = yes(x) if pred else no(x)
    assert calls == ["yes" if pred else "no"] * 2
    assert torch.equal(got["v"], want["v"]) and torch.equal(got["n"], want["n"])


@pytest.mark.parametrize("outer,inner", [(False, False), (False, True), (True, False),
                                         (True, True)])
def test_nested_device_cond_is_a_nested_if(outer, inner):
    x = torch.tensor([1.0, 2.0])

    def branch(v):
        return device_cond(torch.tensor(inner), lambda w: w + 10, lambda w: w + 100, (v,))

    got = device_cond(torch.tensor(outer), branch, lambda v: v, (x,))
    want = (x + 10 if inner else x + 100) if outer else x
    assert torch.equal(got, want)


def test_warm_runs_both_branches_and_returns_the_true_one():
    x = torch.tensor([3.0])
    calls = []

    def yes(v):
        calls.append("yes")
        return (v + 1, v > 0)

    def no(v):
        calls.append("no")
        return (v - 1, v < 0)

    got = warm(lambda: device_cond(torch.tensor(False), yes, no, (x,)))
    assert calls == ["yes", "no"]
    assert torch.equal(got[0], x + 1) and bool(got[1])
    # Branches must agree in form, as lax.cond's do.
    with pytest.raises(ValueError, match="shape or dtype"):
        warm(lambda: device_cond(torch.tensor(True), lambda: x, lambda: x.double()))
    with pytest.raises(ValueError, match="shape or dtype"):
        warm(lambda: device_cond(torch.tensor(True), lambda: (x,), lambda: (x, x)))


def _loop_step(turns):
    def step(carry):
        turns.append(1)
        x, k = carry
        return (x * 0.5 + k, k + 1), (x * x).sum()
    return step


@pytest.mark.parametrize("iters", [1, 3, 20])
def test_device_loop_is_a_python_loop(iters):
    """Eagerly ``device_loop`` runs its step ``iters`` times, as the
    reference's ``lax.scan``: the last carry and every turn's y, stacked."""
    turns = []
    carry = (torch.arange(4.0), torch.tensor(1.0))
    (x, k), ys = device_loop(iters, _loop_step(turns), carry)
    want_x, want_k, want_ys = carry[0], carry[1], []
    for _ in range(iters):
        want_ys.append((want_x * want_x).sum())
        want_x, want_k = want_x * 0.5 + want_k, want_k + 1
    assert len(turns) == iters and ys.shape == (iters,)
    assert torch.equal(x, want_x) and torch.equal(k, want_k)
    assert torch.equal(ys, torch.stack(want_ys))


def test_warm_runs_one_turn_of_a_device_loop():
    """Inside ``warm`` a loop runs one turn (what a capture records) and
    keeps the ys' shape."""
    turns = []
    out = []
    warm(lambda: out.append(device_loop(20, _loop_step(turns),
                                        (torch.arange(4.0), torch.tensor(1.0)))))
    (x, k), ys = out[0]
    assert len(turns) == 1 and ys.shape == (20,) and float(k) == 2.0


def test_tree_leaves_orders_dataclasses_and_dict_keys():
    state = VOState.empty(P.torch_config())
    leaves = tree_leaves({"b": state, "a": (torch.zeros(1), [torch.ones(2)])})
    assert leaves[0].shape == (1,) and leaves[1].shape == (2,)
    assert leaves[2] is state.map.X and leaves[-1] is state.threshold


def test_chunk_graph_needs_the_card():
    cfg = P.torch_config()
    state = VOState.empty(cfg)
    with pytest.raises(ValueError, match="on the card"):
        ChunkGraph(P.cameras()[1], cfg, state, torch.zeros((120, 160)), Sampler(0))


def test_batch_graph_needs_the_card():
    """The batched graph is refused for a CPU state, and asked for the card
    where there is none it raises: nothing falls back to the eager step."""
    cfg = P.torch_config()
    states = VOState.stack([VOState.empty(cfg)] * 2)
    images = torch.zeros((2, 120, 160))
    with pytest.raises(ValueError, match="on the card"):
        BatchGraph(P.cameras()[1], cfg, states, images, [Sampler(0), Sampler(1)])
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        BatchGraph(P.cameras()[1], cfg, VOState.stack([VOState.empty(cfg, "cuda")] * 2),
                   images.cuda(), [Sampler(0), Sampler(1)])


def test_slam_programs_need_the_card():
    """A captured program built for the CPU is refused, and the SLAM layer
    asked for the card where there is none raises: nothing falls back to
    the eager functions or to the CPU."""
    from tinyslam_tpu_torch.models.slam import DeviceSlam, Slam, solve_graph

    with pytest.raises(ValueError, match="on the card"):
        Program(lambda s: s["x"] + 1, {"x": torch.zeros(3)}, "cpu")
    if torch.cuda.is_available():
        return
    cfg, cam = P.torch_config(), P.cameras()[1]
    snap = (np.eye(3, dtype=np.float32)[None], np.zeros((1, 3), np.float32), [])
    for build in (lambda: DeviceSlam(cfg, cam, chunk=4, device="cuda"),
                  lambda: Slam(cfg, cam, device="cuda"),
                  lambda: solve_graph(cfg, snap, "cuda")):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


# ---------------- keyed relocalization draws ----------------
def test_keyed_reloc_draws_ignore_what_was_drawn_before():
    shape = (512, 6)
    fresh = Sampler(3).uniform(shape, "cpu", key=("reloc", torch.tensor(9, dtype=torch.int32)))
    s = Sampler(3)
    s.uniform((64, 5), "cpu", key=("two_view", 4, "E"))
    s.uniform(shape, "cpu", key=("reloc", 8))
    # A speculative draw: a warm step draws both attempts of every frame.
    warm(lambda: device_cond(torch.tensor(True),
                             lambda: s.uniform(shape, "cpu", key=("reloc", 9)),
                             lambda: s.uniform(shape, "cpu", key=("reloc", 11))))
    s.choice(torch.ones(40, dtype=torch.bool), shape, key=("reloc", 12))
    again = s.uniform(shape, "cpu", key=("reloc", 9))
    assert torch.equal(fresh, again)
    assert torch.equal(again, keyed_uniform(3, RELOC_STREAM, 9, shape, "cpu"))
    # Another frame, another seed: other numbers; all in [0, 1).
    assert not torch.equal(again, s.uniform(shape, "cpu", key=("reloc", 10)))
    assert not torch.equal(again, Sampler(4).uniform(shape, "cpu", key=("reloc", 9)))
    assert 0.0 <= float(again.min()) and float(again.max()) < 1.0
    assert abs(float(again.mean()) - 0.5) < 0.02


def test_keyed_loop_draws_ignore_what_was_drawn_before():
    """A loop candidate's draws depend on (seed, kf * 131 + old) alone, a
    host int or a device scalar, and leave the call-order streams
    (``two_view``, ``host_reloc``) where they were."""
    shape = (8, 6)
    n = 6 * 131 + 2
    fresh = Sampler(5).uniform(shape, "cpu", key=("loop", n))
    a, b = Sampler(5), Sampler(5)
    a.uniform((16, 4), "cpu", key=("two_view", 3, "E"))
    b.uniform((16, 4), "cpu", key=("two_view", 3, "E"))
    a.uniform(shape, "cpu", key=("reloc", 4))
    a.choice(torch.ones(40, dtype=torch.bool), shape, key=("loop", n + 1))
    again = a.uniform(shape, "cpu", key=("loop", torch.tensor(6) * 131 + torch.tensor(2)))
    assert torch.equal(fresh, again)
    assert torch.equal(again, keyed_uniform(5, LOOP_STREAM, n, shape, "cpu"))
    assert not torch.equal(again, keyed_uniform(5, RELOC_STREAM, n, shape, "cpu"))
    assert not torch.equal(again, Sampler(6).uniform(shape, "cpu", key=("loop", n)))
    for key in (("two_view", 9, "H"), ("host_reloc", 4)):
        assert torch.equal(a.uniform((16, 4), "cpu", key=key),
                           b.uniform((16, 4), "cpu", key=key))


def test_keyed_draws_leave_the_other_streams_in_order():
    a, b = Sampler(0), Sampler(0)
    a.uniform((8, 6), "cpu", key=("reloc", 5))
    for key in (("two_view", 3, "E"), ("host_reloc", 4), ("loop", 7)):
        assert torch.equal(a.uniform((16, 4), "cpu", key=key),
                           b.uniform((16, 4), "cpu", key=key))


@pytest.mark.parametrize("stream", [RELOC_STREAM, LOOP_STREAM])
def test_keyed_uniform_is_the_same_from_an_int_and_a_tensor_seed(stream):
    """A seed as a host int and as an int64 device scalar (a graph's seed
    buffer, which holds the seed's low 32 bits) give the same bits, with
    the number a host int or a tensor; seeds above 2**31 and 2**32
    included, and no two seeds alike."""
    seeds = (0, 1, 7, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1, 2**33 + 1, 123456789012)
    shape = (64, 6)
    draws = []
    for seed in seeds:
        word = torch.tensor(seed_word(Sampler(seed)), dtype=torch.int64)
        for n in (9, torch.tensor(9, dtype=torch.int32)):
            want = keyed_uniform(seed, stream, n, shape, "cpu")
            assert torch.equal(keyed_uniform(word, stream, n, shape, "cpu"), want), seed
        draws.append(want)
    # The seed's low 32 bits count: 2**33 + 1 draws as 1 does.
    assert torch.equal(draws[seeds.index(2**33 + 1)], draws[seeds.index(1)])
    distinct = [d for s, d in zip(seeds, draws) if s != 2**33 + 1]
    assert all(not torch.equal(a, b) for i, a in enumerate(distinct) for b in distinct[i + 1:])


def test_a_sampler_keyed_on_a_device_seed_draws_as_its_own():
    """``Sampler.keyed_on``: the copy's keyed streams follow the seed
    tensor, its call-order streams share the sampler's generator in call
    order, and the sampler itself keeps its seed and state."""
    a, b = Sampler(2**31 + 3), Sampler(2**31 + 3)
    buf = torch.tensor(seed_word(a), dtype=torch.int64)
    keyed = a.keyed_on(buf)
    assert isinstance(keyed, Sampler) and a.seed == 2**31 + 3
    assert torch.equal(keyed.uniform((8, 6), "cpu", key=("reloc", 4)),
                       b.uniform((8, 6), "cpu", key=("reloc", 4)))
    buf.fill_(seed_word(Sampler(11)))                   # another seed into the buffer
    assert torch.equal(keyed.uniform((8, 6), "cpu", key=("loop", 5)),
                       Sampler(11).uniform((8, 6), "cpu", key=("loop", 5)))
    assert torch.equal(keyed.uniform((16, 4), "cpu", key=("two_view", 3, "E")),
                       b.uniform((16, 4), "cpu", key=("two_view", 3, "E")))
    assert torch.equal(a.uniform((16, 4), "cpu", key=("host_reloc", 4)),
                       b.uniform((16, 4), "cpu", key=("host_reloc", 4)))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_keyed_draws_look_uniform():
    u = keyed_uniform(0, RELOC_STREAM, torch.tensor(123), (4096, 6), "cpu").numpy()
    hist = np.histogram(u, bins=16, range=(0, 1))[0]
    expected = u.size / 16
    chi2 = float(((hist - expected) ** 2 / expected).sum())
    assert chi2 < 40.0, hist                     # 15 degrees of freedom: p < 1e-3
    assert abs(np.corrcoef(u[:, 0], u[:, 1])[0, 1]) < 0.05


# ---------------- track_chunk against the JAX package ----------------
@pytest.fixture(scope="module")
def feats0():
    jcfg, _ = P.configs()
    f0 = jextract(jnp.asarray(_FRAMES[0]), jnp.float32(jcfg.frontend.threshold),
                  jcfg.frontend)
    return P.features_numpy(f0)


@pytest.fixture(scope="module")
def seed_state(feats0):
    return P.seeded_state(P.torch_config(), feats0, _ROOM, _POSES[0])


def _lost(seed: dict, yaw: float) -> dict:
    """The seeded state marked lost, its stale pose turned by ``yaw`` rad."""
    d = dict(seed)
    dR = np.asarray(jse3.so3_exp(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    d["R"] = (dR @ seed["R"]).astype(np.float32)
    d["t"] = (dR @ seed["t"]).astype(np.float32)
    d["last_tracking"] = np.asarray(False)
    d["frame_idx"] = np.asarray(9, np.int32)
    return d


def _centres(R, t):
    return np.einsum("nji,nj->ni", R, -t)


def _angles(Ra, Rb):
    dR = np.einsum("nij,nik->njk", Ra, Rb)
    return np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))


@pytest.mark.parametrize("frame,yaw", [(1, 0.02), (0, 0.6)], ids=["guided", "global"])
def test_keyed_relocalization_matches_jax(seed_state, frame, yaw):
    """The staged relocalization of ``tests/test_torch_reloc.py`` (the
    guided attempt seats the pose at 0.02 rad off; at 0.6 rad the global
    fallback does) with the port's keyed draws, then four more frames."""
    jcfg, tcfg = P.configs()
    jcam, tcam = P.cameras()
    state = _lost(seed_state, yaw)
    image = np.stack(_FRAMES[frame:frame + 5])
    _, jys = jtrack_chunk(jcam, jcfg, P.jax_state(state), jnp.asarray(image),
                          jnp.ones(len(image), bool))
    new, ys = track_chunk(tcam, tcfg, VOState.from_numpy(state), T(image),
                          [True] * len(image), Sampler(0))
    sj, st = np.asarray(jys["summary"]), ys["summary"].numpy()
    np.testing.assert_array_equal(st[:, _COL["tracking"]], sj[:, _COL["tracking"]])
    assert sj[:, _COL["tracking"]].all()
    for name in ("num_matches", "num_inliers"):
        np.testing.assert_allclose(st[:, _COL[name]], sj[:, _COL[name]], rtol=0.02,
                                   err_msg=name)
    Rj, tj = np.asarray(jys["R"]), np.asarray(jys["t"])
    Rt, tt = ys["R"].numpy(), ys["t"].numpy()
    assert np.linalg.norm(_centres(Rt, tt) - _centres(Rj, tj), axis=1).max() < 2e-3
    assert _angles(Rt, Rj).max() < 1e-3
    assert int(new.frame_idx) == 9 + len(image)


def test_keyed_relocalization_then_keyframes_with_ba_match_jax(feats0):
    """A lost state relocalizes on frame 1 (keyed draws), then frames 2-15
    under the default keyframe policy with a 4-keyframe window: keyframes,
    the window BA once three keyframes exist, culling."""
    jcfg, tcfg = P.configs(keyframes=True, max_keyframes=4)
    jcam, tcam = P.cameras()
    state = _lost(P.seeded_state(tcfg, feats0, _ROOM, _POSES[0]), 0.02)
    images = np.stack(_FRAMES[1:])
    jstate, jys = jtrack_chunk(jcam, jcfg, P.jax_state(state), jnp.asarray(images),
                               jnp.ones(N_TRACKED, bool))
    tstate, tys = track_chunk(tcam, tcfg, VOState.from_numpy(state), T(images),
                              [True] * N_TRACKED, Sampler(0))
    sj, st = np.asarray(jys["summary"]), tys["summary"].numpy()
    assert sj[:, _COL["tracking"]].all(), "the reference lost track"
    assert sj[:, _COL["is_keyframe"]].sum() >= 3, "no window BA in the reference"
    for name in ("tracking", "is_keyframe", "num_features"):
        np.testing.assert_array_equal(st[:, _COL[name]], sj[:, _COL[name]], err_msg=name)
    np.testing.assert_allclose(st[:, _COL["num_landmarks"]], sj[:, _COL["num_landmarks"]],
                               rtol=0.02)
    for name in ("num_matches", "num_inliers"):
        np.testing.assert_allclose(st[:, _COL[name]], sj[:, _COL[name]], rtol=0.03,
                                   err_msg=name)
    Rj, tj = np.asarray(jys["R"]), np.asarray(jys["t"])
    Rt, tt = tys["R"].numpy(), tys["t"].numpy()
    assert np.linalg.norm(_centres(Rt, tt) - _centres(Rj, tj), axis=1).max() < 5e-3
    assert _angles(Rt, Rj).max() < 2e-3
    for name in ("win_valid", "win_kf_id", "num_keyframes", "frames_since_kf"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)


def test_device_vo_on_the_cpu_tracks_eagerly(seed_state):
    """``graph`` asks for the card's graph; on the CPU a chunk runs the plain
    ``track_chunk`` all the same, with the same draws."""
    tcfg = P.torch_config()
    tcam = P.cameras()[1]
    state = _lost(seed_state, 0.02)
    vo = DeviceVO(tcfg, tcam, chunk=4, device="cpu", sampler=Sampler(0), graph=True)
    vo.state = VOState.from_numpy(state)
    vo.run(_FRAMES[1:5])
    _, ys = track_chunk(tcam, tcfg, VOState.from_numpy(state), T(np.stack(_FRAMES[1:5])),
                        [True] * 4, Sampler(0))
    np.testing.assert_array_equal(np.stack([R for R, _ in vo.trajectory]), ys["R"].numpy())
    assert [s.tracking for s in vo.stats] == [True] * 4
