"""The port's geometry, PnP, the tracked-frame slice and its
relocalization branch against the JAX package's.

Tolerances: SE(3) maps atol 1e-5; PnP poses atol 1e-4.  The slice: frame 0
seeds the map (the JAX package's features at their ray-cast 3D points) and
both packages' ``track_chunk`` track frames 1-6.  Per frame, ``tracking``
and ``num_features`` must be equal, matches and inliers within 2%, camera
centres within 2 mm and rotations within 1e-3 rad.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu.frontend.orb import extract_features as jextract
from tinyslam_tpu.geometry import pnp as jpnp, se3 as jse3
from tinyslam_tpu.models.vo_device import track_chunk as jtrack_chunk
from tinyslam_tpu_torch.geometry import pnp as tpnp, se3 as tse3
from tinyslam_tpu_torch.models.vo_device import (
    SUMMARY_FIELDS, DeviceVO, VOState, track_chunk, track_step,
)
from tinyslam_tpu_torch.utils.draws import Sampler

N_TRACKED = 6
_FRAMES, _POSES, _ROOM = P.orbit(N_TRACKED + 1)


def _xi(seed, n, scale):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, scale, (n, 6)).astype(np.float32)
    xi[0] = 0.0                                  # identity
    xi[1, 3:] = [0.0, 0.0, 1e-7]                 # tiny angle
    xi[2, 3:] = [np.pi - 1e-3, 0.0, 0.0]         # near pi
    return xi


@pytest.mark.parametrize("scale", [1e-3, 0.5, 1.5])
def test_se3_exp_log_compose_match_jax(scale):
    xi = _xi(0, 32, scale)
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tse3.se3_log(Rt, tt).numpy(),
                               np.asarray(jse3.se3_log(Rj, tj)), rtol=0, atol=1e-5)
    Rc, tc = tse3.se3_compose(Rt, tt, Rt.flip(0), tt.flip(0))
    Rcj, tcj = jse3.se3_compose(Rj, tj, Rj[::-1], tj[::-1])
    np.testing.assert_allclose(Rc.numpy(), np.asarray(Rcj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(tcj), rtol=0, atol=1e-5)
    Ri, ti = tse3.se3_inverse(Rt, tt)
    Rij, tij = jse3.se3_inverse(Rj, tj)
    np.testing.assert_allclose(Ri.numpy(), np.asarray(Rij), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(tij), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tse3.rotation_to_quaternion(Rt).numpy(),
        np.asarray(jse3.rotation_to_quaternion(Rj)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("outliers", [0.0, 0.3])
def test_pnp_refine_matches_jax(outliers):
    jcam, tcam = P.cameras()
    rng = np.random.default_rng(8)
    n = 200
    X = (rng.uniform(-1, 1, (n, 3)) * [1.5, 1.0, 0.5] + [0, 0, 4]).astype(np.float32)
    R_true, t_true = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(
        np.array([0.05, -0.02, 0.1, 0.02, -0.03, 0.01], np.float32))))
    uv = np.asarray(jcam.project(jnp.asarray(X @ R_true.T + t_true))[0])
    uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    bad = rng.random(n) < outliers
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2)).astype(np.float32)
    valid = rng.random(n) > 0.05
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    j = jpnp.pnp_refine(jcam, *(jnp.asarray(a) for a in (X, uv, valid, R0, t0)))
    t = tpnp.pnp_refine(tcam, *(torch.from_numpy(a) for a in (X, uv, valid, R0, t0)))
    np.testing.assert_allclose(t["R"].numpy(), np.asarray(j["R"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["t"].numpy(), np.asarray(j["t"]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t["inliers"].numpy(), np.asarray(j["inliers"]))
    assert int(t["num_inliers"]) == int(j["num_inliers"])
    np.testing.assert_allclose(float(t["rmse"]), float(j["rmse"]), rtol=1e-4)


def test_camera_project_matches_jax():
    jcam, tcam = P.cameras()
    xc = np.random.default_rng(2).normal(0, 2, (100, 3)).astype(np.float32)
    uj, vj = jcam.project(jnp.asarray(xc))
    ut, vt = tcam.project(torch.from_numpy(xc))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-6)


@pytest.fixture(scope="module")
def slice_run():
    """Seed from the JAX package's frame-0 features; track frames 1-6 in
    both packages."""
    jcfg, tcfg = P.configs()
    jcam, tcam = P.cameras()
    f0 = jextract(jnp.asarray(_FRAMES[0]), jnp.float32(jcfg.frontend.threshold),
                  jcfg.frontend)
    seed = P.seeded_state(tcfg, {k: np.asarray(getattr(f0, k)) for k in
                                 ("xy", "level", "angle", "score", "desc", "valid")},
                          _ROOM, _POSES[0])
    images = np.stack(_FRAMES[1:])
    _, jys = jtrack_chunk(jcam, jcfg, P.jax_state(seed), jnp.asarray(images),
                          jnp.ones(N_TRACKED, bool))
    tstate, tys = track_chunk(tcam, tcfg, VOState.from_numpy(seed),
                              torch.from_numpy(images), [True] * N_TRACKED, Sampler(0))
    return {"seed": seed, "cfg": tcfg, "cam": tcam, "state": tstate,
            "jax": {k: np.asarray(v) for k, v in jys.items()},
            "torch": {k: v.numpy() for k, v in tys.items()}}


def _centres(R, t):
    return np.einsum("nji,nj->ni", R, -t)


def test_slice_tracks_like_jax(slice_run):
    j, t = slice_run["jax"], slice_run["torch"]
    col = {name: i for i, name in enumerate(SUMMARY_FIELDS)}
    sj, st = j["summary"], t["summary"]
    assert sj[:, col["tracking"]].all(), "the reference lost track"
    np.testing.assert_array_equal(st[:, col["tracking"]], sj[:, col["tracking"]])
    np.testing.assert_array_equal(st[:, col["num_features"]], sj[:, col["num_features"]])
    np.testing.assert_array_equal(st[:, col["is_keyframe"]], 0)
    for name in ("num_matches", "num_inliers"):
        np.testing.assert_allclose(st[:, col[name]], sj[:, col[name]], rtol=0.02, err_msg=name)
    np.testing.assert_allclose(st[:, col["threshold"]], sj[:, col["threshold"]], rtol=1e-6)
    dc = np.linalg.norm(_centres(t["R"], t["t"]) - _centres(j["R"], j["t"]), axis=1)
    assert dc.max() < 2e-3, dc
    dR = np.einsum("nij,nik->njk", t["R"], j["R"])
    angle = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert angle.max() < 1e-3, angle


def test_slice_close_to_ground_truth(slice_run):
    t = slice_run["torch"]
    gt = np.stack([-R.T @ tt for R, tt in _POSES[1:]])
    assert np.linalg.norm(_centres(t["R"], t["t"]) - gt, axis=1).max() < 0.1


def test_device_vo_partial_chunk_same_trajectory(slice_run):
    vo = DeviceVO(slice_run["cfg"], slice_run["cam"], chunk=4, device="cpu")
    vo.state = VOState.from_numpy(slice_run["seed"])
    stats = vo.run(_FRAMES[1:])                  # 4 + a partial chunk of 2
    assert len(stats) == N_TRACKED and all(s.tracking for s in stats)
    t = slice_run["torch"]
    np.testing.assert_allclose(vo.positions, _centres(t["R"], t["t"]), rtol=0, atol=1e-6)
    assert [s.num_inliers for s in stats] == t["summary"][:, 2].astype(int).tolist()
    np.testing.assert_array_equal(vo.state.R.numpy(), slice_run["state"].R.numpy())


def test_inactive_frames_leave_the_state(slice_run):
    state = VOState.from_numpy(slice_run["seed"])
    images = torch.from_numpy(np.stack(_FRAMES[1:3]))
    out, ys = track_chunk(slice_run["cam"], slice_run["cfg"], state, images, [False, False],
                          Sampler(0))
    assert out is state
    np.testing.assert_array_equal(ys["summary"].numpy(), 0)
    assert ys["R"].shape == (2, 3, 3) and ys["t"].shape == (2, 3)


def test_state_numpy_round_trip(slice_run):
    d = slice_run["state"].to_numpy()
    back = VOState.from_numpy(d).to_numpy()
    assert d.keys() == back.keys() == slice_run["seed"].keys()
    for k in d:
        assert back[k].dtype == d[k].dtype and back[k].shape == d[k].shape, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    assert d["map.desc"].dtype == np.uint32


def test_lost_frame_raises_relocalization(slice_run):
    """A frame after a lost one relocalizes (staged PnP-RANSAC) as the JAX
    ``track_step`` does with ``last_tracking=False``, the JAX draws
    injected: the same tracking flag, matches and inliers within 2%, the
    pose within 2 mm and 1e-3 rad, and the velocity model reset."""
    jcfg, tcfg = P.configs()
    jcam, tcam = P.cameras()
    seed = dict(slice_run["seed"], last_tracking=np.asarray(False))
    image = np.stack(_FRAMES[1:2])
    _, jys = jtrack_chunk(jcam, jcfg, P.jax_state(seed), jnp.asarray(image),
                          jnp.ones(1, bool))
    sampler = P.JaxSampler()
    new, ys = track_chunk(tcam, tcfg, VOState.from_numpy(seed), torch.from_numpy(image),
                          [True], sampler)
    assert sampler.calls[0] == ("reloc", 0)
    sj, st = np.asarray(jys["summary"])[0], ys["summary"].numpy()[0]
    col = {name: i for i, name in enumerate(SUMMARY_FIELDS)}
    assert st[col["tracking"]] == sj[col["tracking"]] == 1
    for name in ("num_matches", "num_inliers"):
        np.testing.assert_allclose(st[col[name]], sj[col[name]], rtol=0.02, err_msg=name)
    dc = _centres(ys["R"].numpy(), ys["t"].numpy()) - _centres(np.asarray(jys["R"]),
                                                             np.asarray(jys["t"]))
    assert np.abs(dc).max() < 2e-3
    np.testing.assert_allclose(ys["R"].numpy(), np.asarray(jys["R"]), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(new.vel_R.numpy(), np.eye(3, dtype=np.float32))
    assert bool(new.last_tracking)


def test_keyframe_needed_inserts_keyframe_0_under_default_vo_config(slice_run):
    _, kcfg = P.configs(keyframes=True)          # default keyframe policy
    # 138 inliers < keyframe_min_inliers, past keyframe_min_interval.
    state = VOState.from_numpy(slice_run["seed"]).replace(
        frames_since_kf=torch.tensor(3, dtype=torch.int32))
    new, ys = track_step(slice_run["cam"], kcfg, state, torch.from_numpy(_FRAMES[1]),
                         Sampler(0))
    s = dict(zip(SUMMARY_FIELDS, ys["summary"].tolist()))
    assert s["tracking"] == 1 and s["is_keyframe"] == 1
    assert int(new.num_keyframes) == 1 and int(new.frames_since_kf) == 0
    assert new.win_valid.tolist() == [True] + [False] * (len(new.win_valid) - 1)
    assert int(new.win_kf_id[0]) == 0
    assert torch.equal(new.win_R[0], new.R) and torch.equal(new.kf_ring.valid[0],
                                                             new.win_feats.valid[0])
    # The seeded window is empty, so keyframe 0 triangulates nothing; its
    # observations of the seeded map are recorded in slot 0.
    assert s["num_landmarks"] == int(state.map.valid.sum())
    assert int(new.win_mask[0].sum()) > 100
    assert int((new.map.last_seen == 0).sum()) == int(new.win_mask[0].sum())


def test_device_vo_needs_a_state(slice_run):
    """DeviceVO needs no state handed over: it bootstraps one from frame 0
    (the reference, with its draws, succeeds at frame 6 of the orbit)."""
    vo = DeviceVO(slice_run["cfg"], slice_run["cam"], chunk=4, device="cpu",
                  sampler=P.JaxSampler())
    for i, frame in enumerate(_FRAMES):
        assert vo.initialized == (i > 6)
        vo.process(frame)
    assert vo.initialized and vo.host_frames == 7 and vo.num_keyframes == 2
    assert [s.tracking for s in vo.stats] == [False] * 6 + [True]
    assert int(vo.state.frame_idx) == 7 and bool(vo.state.last_tracking)
    assert int(vo.map.valid.sum()) == vo.stats[-1].num_landmarks >= 50
    with pytest.raises(ValueError):
        DeviceVO(slice_run["cfg"], slice_run["cam"], chunk=64, device="cpu")


def test_device_vo_keeps_one_device(slice_run):
    """The device is a required argument, and a state assigned from
    another device is refused (a reboot would otherwise bootstrap, and
    then track, on the DeviceVO's device instead of the state's)."""
    with pytest.raises(TypeError):
        DeviceVO(slice_run["cfg"], slice_run["cam"], chunk=4)
    vo = DeviceVO(slice_run["cfg"], slice_run["cam"], chunk=4, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        vo.state = VOState.from_numpy(slice_run["seed"], "meta")
    assert vo.state is None
    vo.state = VOState.from_numpy(slice_run["seed"], "cpu")
    assert vo.initialized and vo.state.device == vo.device
