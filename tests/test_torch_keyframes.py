"""The port's keyframe insertion, map maintenance and the keyframe slice
against the JAX package's.

Tolerances: ``_record_obs`` (repeated map slots, a valid row before
invalid ones), the last-write scatter, ``_push_keyframe`` (window free,
with a hole, and full: the roll), ``_cull_landmarks``, ``_newest_slot``,
``_best_baseline_slot`` and ``_record_kf_obs``: exact.
``_triangulate_and_insert`` of orbit frame 3 or 15 against frame 0 at
their ground-truth poses: the inserted count, slots, descriptors and
bookkeeping equal; X atol 1e-4 for frame 15, 2e-3 for frame 3.  Frame 3
has a 0.12 m baseline to points up to 6 m deep, where the 3x3 normal
equations are so ill-conditioned that float32 carries millimetres of
error in either package (the reference's own distance from a float64
solve of the same equations reaches 3 cm over this pair's matches).

The slice: frame 0 seeds the map, both packages' ``track_chunk`` track
frames 1-15 under the default keyframe policy with
``BAConfig(max_keyframes=4)``; per frame ``tracking`` and ``is_keyframe``
equal, landmarks within 2%, matches and inliers within 3%, camera centres
within 5 mm and rotations within 2e-3 rad; the final window and keyframe
count equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu.frontend.orb import extract_features as jextract
from tinyslam_tpu.models import vo as jvo, vo_device as jvd
from tinyslam_tpu.models.vo import MapState as JMapState
from tinyslam_tpu_torch.models import vo as tvo, vo_device as tvd
from tinyslam_tpu_torch.models.vo import MapState
from tinyslam_tpu_torch.models.vo_device import SUMMARY_FIELDS, DeviceVO, VOState
from tinyslam_tpu_torch.ops.hamming import match_descriptors
from tinyslam_tpu_torch.types import Features
from tinyslam_tpu_torch.utils.draws import Sampler

N_TRACKED = 15
KEYFRAMES = [3, 6, 9, 12, 15]            # where the reference inserts them
_FRAMES, _POSES, _ROOM = P.orbit(N_TRACKED + 1)
_COL = {name: i for i, name in enumerate(SUMMARY_FIELDS)}


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))      # a writable copy


def _numpy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal_fields(t, j, names):
    for name in names:
        a, b = _numpy(getattr(t, name)), np.asarray(getattr(j, name))
        if a.dtype == np.int32 and b.dtype == np.uint32:
            a = a.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def feats():
    """The JAX package's features of orbit frames 0, 3 and 15 (the port's
    extraction is bit-equal to them)."""
    jcfg, _ = P.configs()
    return {i: P.features_numpy(jextract(jnp.asarray(_FRAMES[i]),
                                         jnp.float32(jcfg.frontend.threshold),
                                         jcfg.frontend))
            for i in (0, 3, 15)}


@pytest.mark.parametrize("shape", [(), (2,), (8,)])
def test_last_write_scatter_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    m, n = 10, 24
    dtype = np.uint32 if shape == (8,) else np.float32
    dst = rng.integers(0, 1000, (m, *shape)).astype(dtype)
    src = rng.integers(0, 1000, (n, *shape)).astype(dtype)
    idx = rng.integers(0, m - 3, n).astype(np.int32)        # repeats; 3 slots unwritten
    want = np.asarray(jnp.asarray(dst).at[jnp.asarray(idx)].set(jnp.asarray(src)))
    view = (lambda a: a.view(np.int32)) if dtype == np.uint32 else (lambda a: a)
    got = tvo._scatter_set(T(view(dst)), tvo._last_writer(T(idx), m), T(view(src)))
    np.testing.assert_array_equal(got.numpy(), view(want))


@pytest.mark.parametrize("gate", [False, True])
def test_record_obs_duplicate_indices_bit_equal(gate):
    rng = np.random.default_rng(11)
    K, M = 3, 10
    win_obs = rng.normal(0, 50, (K, M, 2)).astype(np.float32)
    win_mask = rng.random((K, M)) > 0.5
    # Slot 3 is written by a valid row and then by invalid rows; slot 5 by
    # an invalid row and then a valid one; slot 0 only by invalid rows.
    idx = np.array([3, 5, 3, 5, 3, 0, 7, 0, 9, 3], np.int32)
    valid = np.array([1, 0, 0, 1, 0, 0, 1, 0, 1, 0], bool)
    map_X = (rng.uniform(-1, 1, (M, 3)) + [0, 0, 3]).astype(np.float32)
    uv = ((map_X[idx, :2] / map_X[idx, 2:]) * P.CAMERA["fx"]
          + [P.CAMERA["cx"], P.CAMERA["cy"]]).astype(np.float32)
    uv[6] += 20.0                                            # fails the 8 px gate
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    jcam, tcam = P.cameras()
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jkw = dict(cam=jcam, map_X=jnp.asarray(map_X), R=jnp.asarray(eye),
               t=jnp.asarray(zero)) if gate else {}
    tkw = dict(cam=tcam, map_X=T(map_X), R=T(eye), t=T(zero)) if gate else {}
    j = jvo._record_obs(jnp.asarray(win_obs), jnp.asarray(win_mask), jnp.int32(1),
                        jnp.asarray(idx), jnp.asarray(uv), jnp.asarray(valid), **jkw)
    t = tvo._record_obs(T(win_obs), T(win_mask), torch.tensor(1), T(idx), T(uv),
                        T(valid), **tkw)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not np.array_equal(t[0].numpy(), win_obs)


def _random_state(seed, win_valid, K=4):
    """A flat numpy VOState of the small set-up with random contents."""
    rng = np.random.default_rng(seed)
    d = VOState.empty(P.torch_config(max_keyframes=K)).to_numpy()
    for k, a in d.items():
        if a.dtype == np.float32:
            d[k] = rng.normal(0, 1, a.shape).astype(np.float32)
        elif a.dtype == np.bool_:
            d[k] = rng.random(a.shape) > 0.5
        elif a.dtype == np.uint32:
            d[k] = rng.integers(0, 2**32 - 1, a.shape, np.uint32)
        else:
            d[k] = rng.integers(-1, 14, a.shape).astype(a.dtype)
    d["win_valid"] = np.asarray(win_valid, bool)
    d["win_kf_id"] = np.where(d["win_valid"], rng.permutation(K) + 5, -1).astype(np.int32)
    return d


@pytest.mark.parametrize("win_valid,slot", [([1, 1, 0, 0], 2), ([1, 0, 1, 0], 1),
                                            ([1, 1, 1, 1], 3)], ids=["free", "hole", "full"])
def test_push_keyframe_matches_jax(win_valid, slot):
    d = _random_state(1, win_valid)
    f = _random_state(2, win_valid)
    new = {k[len("win_feats."):]: f[k][0] for k in f if k.startswith("win_feats.")}
    R, t = f["R"], f["t"]
    js, jslot = jvd._push_keyframe(P.jax_state(d), jnp.asarray(R), jnp.asarray(t),
                                   P.jax_features(new), jnp.int32(9))
    ts, tslot = tvd._push_keyframe(VOState.from_numpy(d), T(R), T(t),
                                   Features.from_numpy(new), torch.tensor(9, dtype=torch.int32))
    assert int(tslot) == int(jslot) == slot
    _assert_equal_fields(ts, js, ("win_R", "win_t", "win_obs", "win_mask", "win_valid",
                                  "win_kf_id"))
    _assert_equal_fields(ts.win_feats, js.win_feats, P.FEATURE_FIELDS)


@pytest.mark.parametrize("seed", [3, 4])
def test_cull_and_slot_choice_match_jax(seed):
    d = _random_state(seed, [1, 0, 1, 1])
    js, ts = P.jax_state(d), VOState.from_numpy(d)
    kf_id = 12
    _assert_equal_fields(tvd._cull_landmarks(ts, torch.tensor(kf_id, dtype=torch.int32)).map,
                         jvd._cull_landmarks(js, jnp.int32(kf_id)).map, ("valid",))
    assert int(tvd._newest_slot(ts.win_kf_id)) == int(jvd._newest_slot(js.win_kf_id))
    assert int(tvd._best_baseline_slot(ts)) == int(jvd._best_baseline_slot(js))


def _seeded_map(feats0, keep_every: int) -> dict:
    """The map of frame 0's features at their ray-cast points, every
    ``keep_every``-th one kept valid."""
    d = P.seeded_state(P.torch_config(), feats0, _ROOM, _POSES[0])
    m = {k[len("map."):]: v for k, v in d.items() if k.startswith("map.")}
    m["valid"] = m["valid"] & (np.arange(len(m["valid"])) % keep_every == 0)
    return m


@pytest.mark.parametrize("frame,case,atol", [
    (3, "empty map", 2e-3), (3, "half map in view", 2e-3), (15, "half map in view", 1e-4)])
def test_triangulate_and_insert_matches_jax(feats, frame, case, atol):
    """A frame against frame 0 at their ground-truth poses.  With half of
    frame 0's points in the map, more than 30 are in view, so the scene
    and the local depth bands both gate."""
    jcfg, tcfg = P.configs()
    jcam, tcam = P.cameras()
    f3, f0 = feats[frame], feats[0]
    if case == "empty map":
        m = MapState.empty(P.MAP_POINTS).to_numpy()
        already = np.zeros(len(f3["valid"]), bool)
    else:
        m = _seeded_map(f0, 2)
        R3, t3 = _POSES[frame]
        pc = m["X"] @ R3.T + t3
        uv = pc[:, :2] / pc[:, 2:] * P.CAMERA["fx"]
        assert (m["valid"] & (pc[:, 2] > 0) & (np.abs(uv[:, 0]) < 79)
                & (np.abs(uv[:, 1]) < 59)).sum() > 30
        already = np.random.default_rng(5).random(len(f3["valid"])) < 0.2
    tf3, tf0 = Features.from_numpy(f3), Features.from_numpy(f0)
    mt = match_descriptors(tf3.desc, tf3.valid, tf0.desc, tf0.valid,
                           max_distance=64, ratio=0.9, cross_check=True)
    idx_b, pair_valid = mt["idx_b"].numpy(), mt["valid"].numpy()
    kw = dict(max_new=tcfg.frontend.features_per_level, band_lo=tcfg.vo.tri_band_lo,
              band_hi=tcfg.vo.tri_band_hi, dup_radius_px=tcfg.vo.dup_radius_px,
              local_band=tcfg.vo.tri_local_band)
    (Ra, ta), (Rb, tb) = _POSES[frame], _POSES[0]
    jm, jn = jvo._triangulate_and_insert(
        jcam, JMapState(**{k: jnp.asarray(v) for k, v in m.items()}), jnp.int32(1),
        jnp.asarray(Ra), jnp.asarray(ta), P.jax_features(f3),
        jnp.asarray(Rb), jnp.asarray(tb), P.jax_features(f0),
        jnp.asarray(idx_b), jnp.asarray(pair_valid), jnp.asarray(already), **kw)
    tm, tn = tvo._triangulate_and_insert(
        tcam, MapState.from_numpy(m), torch.tensor(1, dtype=torch.int32),
        T(Ra).float(), T(ta).float(), tf3, T(Rb).float(), T(tb).float(), tf0,
        T(idx_b), T(pair_valid), T(already), **kw)
    assert int(tn) == int(jn) > 0
    _assert_equal_fields(tm, jm, ("valid", "desc", "anchor_kf", "obs_count", "last_seen"))
    np.testing.assert_allclose(tm.X.numpy(), np.asarray(jm.X), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def slice_run(feats):
    """Seed from frame 0; track frames 1-15 in both packages under the
    default keyframe policy with a 4-keyframe window."""
    jcfg, tcfg = P.configs(keyframes=True, max_keyframes=4)
    jcam, tcam = P.cameras()
    seed = P.seeded_state(tcfg, feats[0], _ROOM, _POSES[0])
    images = np.stack(_FRAMES[1:])
    jstate, jys = jvd.track_chunk(jcam, jcfg, P.jax_state(seed), jnp.asarray(images),
                                  jnp.ones(N_TRACKED, bool))
    tstate, tys = tvd.track_chunk(tcam, tcfg, VOState.from_numpy(seed),
                                  torch.from_numpy(images), [True] * N_TRACKED, Sampler(0))
    return {"seed": seed, "cfg": (jcfg, tcfg), "cam": (jcam, tcam),
            "state": (jstate, tstate),
            "jax": {k: np.asarray(v) for k, v in jys.items()},
            "torch": {k: v.numpy() for k, v in tys.items()}}


def _centres(R, t):
    return np.einsum("nji,nj->ni", R, -t)


def test_keyframe_slice_tracks_like_jax(slice_run):
    j, t = slice_run["jax"], slice_run["torch"]
    sj, st = j["summary"], t["summary"]
    assert sj[:, _COL["tracking"]].all(), "the reference lost track"
    np.testing.assert_array_equal(np.flatnonzero(sj[:, _COL["is_keyframe"]]) + 1, KEYFRAMES)
    for name in ("tracking", "is_keyframe", "num_features"):
        np.testing.assert_array_equal(st[:, _COL[name]], sj[:, _COL[name]], err_msg=name)
    np.testing.assert_allclose(st[:, _COL["num_landmarks"]], sj[:, _COL["num_landmarks"]],
                               rtol=0.02)
    assert st[-1, _COL["num_landmarks"]] > st[0, _COL["num_landmarks"]]
    for name in ("num_matches", "num_inliers"):
        np.testing.assert_allclose(st[:, _COL[name]], sj[:, _COL[name]], rtol=0.03, err_msg=name)
    dc = np.linalg.norm(_centres(t["R"], t["t"]) - _centres(j["R"], j["t"]), axis=1)
    assert dc.max() < 5e-3, dc
    dR = np.einsum("nij,nik->njk", t["R"], j["R"])
    angle = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert angle.max() < 2e-3, angle


def test_keyframe_slice_final_window_matches_jax(slice_run):
    jstate, tstate = slice_run["state"]
    _assert_equal_fields(tstate, jstate, ("win_valid", "win_kf_id", "num_keyframes",
                                          "frames_since_kf"))
    assert int(tstate.num_keyframes) == len(KEYFRAMES)
    # The ring holds each keyframe's features at kf_id % KF_RING.
    ring_valid = tstate.kf_ring.valid.any(1).numpy()
    np.testing.assert_array_equal(np.flatnonzero(ring_valid), np.arange(len(KEYFRAMES)))


def test_record_kf_obs_matches_jax(slice_run):
    """Re-observe the map from the oldest window keyframe of the slice's
    final state: guided match at r=32, gated window observations, the
    last-write descriptor and last_seen updates, obs_count adds."""
    jcfg, tcfg = slice_run["cfg"]
    jcam, tcam = slice_run["cam"]
    d = slice_run["state"][1].to_numpy()
    js, ts = P.jax_state(d), VOState.from_numpy(d)
    slot = int(np.argmin(np.where(d["win_valid"], d["win_kf_id"], 1 << 30)))
    jf = P.jax_features({k: d["win_feats." + k][slot] for k in P.FEATURE_FIELDS})
    tf = ts.win_feats.map(lambda x: x[slot])
    jo = jvd._record_kf_obs(jcam, jcfg, js, jnp.int32(slot), jf)
    to = tvd._record_kf_obs(tcam, tcfg, ts, torch.tensor(slot), tf)
    _assert_equal_fields(to, jo, ("win_obs", "win_mask"))
    _assert_equal_fields(to.map, jo.map, ("desc", "obs_count", "last_seen"))
    assert (to.map.obs_count.numpy() > ts.map.obs_count.numpy()).sum() > 20


def test_device_vo_run_with_keyframes_matches_track_chunk(slice_run):
    _, tcfg = slice_run["cfg"]
    vo = DeviceVO(tcfg, slice_run["cam"][1], chunk=4, device="cpu")
    assert vo.num_keyframes == 0 and int(vo.map.valid.sum()) == 0
    vo.state = VOState.from_numpy(slice_run["seed"])
    stats = vo.run(_FRAMES[1:])                  # 3 chunks of 4 + a partial 3
    t = slice_run["torch"]
    np.testing.assert_allclose(vo.positions, _centres(t["R"], t["t"]), rtol=0, atol=1e-6)
    assert [s.is_keyframe for s in stats] == [f in KEYFRAMES for f in range(1, 16)]
    assert [s.num_landmarks for s in stats] == t["summary"][:, _COL["num_landmarks"]].tolist()
    assert vo.num_keyframes == len(KEYFRAMES)
    assert int(vo.map.valid.sum()) == stats[-1].num_landmarks


def test_keyframe_slice_close_to_ground_truth(slice_run):
    t = slice_run["torch"]
    gt = np.stack([-R.T @ tt for R, tt in _POSES[1:]])
    err = np.linalg.norm(_centres(t["R"], t["t"]) - gt, axis=1)
    assert np.isfinite(err).all() and err.max() < 0.5, err
