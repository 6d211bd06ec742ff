"""The port's relocalization against the JAX package's: ``_dlt_pose``,
``pnp_ransac`` with the JAX package's categorical samples, and the staged
relocalization branch of ``track_step`` (guided at 64 px, and with the
global fallback), with the JAX draws injected (``torch_parity.JaxSampler``).

Tolerances: ``_dlt_pose`` on noise-free minimal samples R atol 3e-4, t
atol 1e-3, each package within 1e-3 of the true pose (the port's null
vector comes from inverse iteration, the reference's from XLA's CPU
``eigh``, which leaves up to 1.4e-4 in R here); ``pnp_ransac`` R atol 1e-4, t atol 1e-3,
inlier counts within 1% and the raw vote equal.  The staged branch: the
same tracking flag, matches and inliers within 2%, camera centres within
2 mm and rotations within 1e-3 rad.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu.frontend.orb import extract_features as jextract
from tinyslam_tpu.geometry import pnp as jpnp, se3 as jse3
from tinyslam_tpu.models.vo_device import track_chunk as jtrack_chunk
from tinyslam_tpu_torch.geometry import pnp as tpnp
from tinyslam_tpu_torch.models import vo_device as tvd
from tinyslam_tpu_torch.models.vo import _reloc_attempt
from tinyslam_tpu_torch.models.vo_device import SUMMARY_FIELDS, VOState, track_chunk

_COL = {name: i for i, name in enumerate(SUMMARY_FIELDS)}
_FRAMES, _POSES, _ROOM = P.orbit(2)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _scene(seed: int, n: int, outliers: float, noise: float = 0.5):
    """n world points in front of a camera at a known pose, their pixels
    with ``noise`` px noise, a share of them replaced by random pixels."""
    jcam, _ = P.cameras()
    rng = np.random.default_rng(seed)
    X = (rng.uniform(-1, 1, (n, 3)) * [2.0, 1.5, 1.0] + [0, 0, 4]).astype(np.float32)
    R, t = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(
        np.array([0.1, -0.05, 0.2, 0.05, -0.1, 0.03], np.float32))))
    uv = np.asarray(jcam.project(jnp.asarray(X @ R.T + t))[0])
    uv = (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)
    bad = rng.random(n) < outliers
    uv[bad] = rng.uniform(0, [160, 120], (int(bad.sum()), 2)).astype(np.float32)
    valid = rng.random(n) > 0.05
    return X, uv, valid, R, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dlt_pose_matches_jax(seed):
    jcam, tcam = P.cameras()
    X, uv, _, R, t = _scene(seed, 6, 0.0, noise=0.0)
    w = np.ones(6, np.float32)
    Rj, tj = (np.asarray(a) for a in jpnp._dlt_pose(jcam, *(jnp.asarray(a) for a in (X, uv, w))))
    Rt, tt = tpnp._dlt_pose(tcam, T(X), T(uv), T(w))
    np.testing.assert_allclose(Rt.numpy(), Rj, rtol=0, atol=3e-4)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=0, atol=1e-3)
    np.testing.assert_allclose(Rt.numpy(), R, rtol=0, atol=1e-3)
    np.testing.assert_allclose(Rj, R, rtol=0, atol=1e-3)
    # A batch of samples at once, the relocalization's shape.
    Xb, uvb = np.stack([X, X[::-1]]), np.stack([uv, uv[::-1]])
    Rb, tb = tpnp._dlt_pose(tcam, T(Xb), T(uvb), T(np.ones((2, 6), np.float32)))
    np.testing.assert_allclose(Rb.numpy(), np.stack([Rt.numpy()] * 2), rtol=0, atol=1e-4)


@pytest.mark.parametrize("prior", [False, True])
def test_pnp_ransac_matches_jax(prior):
    jcam, tcam = P.cameras()
    X, uv, valid, R, t = _scene(3, 300, 0.45)
    sampler = P.JaxSampler()
    sample = sampler.choice(T(valid), (512, 6), key=("reloc", 5))
    kw = {}
    if prior:       # a stale pose: 0.05 rad and 10 cm off
        dR = np.asarray(jse3.so3_exp(jnp.asarray([0.0, 0.05, 0.0], jnp.float32)))
        kw = dict(R_prior=(dR @ R).astype(np.float32), t_prior=(t + [0.1, 0, 0]).astype(np.float32))
    want = jpnp.pnp_ransac(jcam, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                           jax.random.fold_in(jax.random.PRNGKey(17), 5), num_hypotheses=512,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tpnp.pnp_ransac(tcam, T(X), T(uv), T(valid), sample,
                          **{k: T(v) for k, v in kw.items()})
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(want["R"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]), rtol=0, atol=1e-3)
    nj = int(want["num_inliers"])
    assert abs(int(got["num_inliers"]) - nj) <= max(1, 0.01 * nj)
    assert int(got["hypothesis_inliers"]) == int(want["hypothesis_inliers"])
    assert (got["inliers"].numpy() != np.asarray(want["inliers"])).sum() <= max(1, 0.01 * nj)
    np.testing.assert_allclose(float(got["rmse"]), float(want["rmse"]), rtol=1e-2)
    np.testing.assert_allclose(got["R"].numpy(), R, rtol=0, atol=5e-3)


def test_pnp_refine_batches_match_single_refines():
    """The relocalization polishes its best hypotheses as one batch."""
    _, tcam = P.cameras()
    X, uv, valid, R, t = _scene(4, 200, 0.2)
    rng = np.random.default_rng(4)
    R0 = np.stack([R, R, np.eye(3, dtype=np.float32)])
    t0 = np.stack([t, t + [0.05, 0, 0], t]).astype(np.float32)
    masks = np.stack([valid, valid & (rng.random(200) > 0.3), valid])
    got = tpnp.pnp_refine(tcam, T(X), T(uv), T(masks), T(R0), T(t0))
    for b in range(3):
        one = tpnp.pnp_refine(tcam, T(X), T(uv), T(masks[b]), T(R0[b]), T(t0[b]))
        np.testing.assert_allclose(got["R"][b].numpy(), one["R"].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["t"][b].numpy(), one["t"].numpy(), rtol=0, atol=1e-5)
        assert int(got["num_inliers"][b]) == int(one["num_inliers"])


@pytest.fixture(scope="module")
def seed_state():
    jcfg, tcfg = P.configs()
    f0 = jextract(jnp.asarray(_FRAMES[0]), jnp.float32(jcfg.frontend.threshold), jcfg.frontend)
    return P.seeded_state(tcfg, P.features_numpy(f0), _ROOM, _POSES[0])


def _lost(seed: dict, yaw: float) -> dict:
    """The seeded state marked lost, its stale pose turned by ``yaw`` rad
    about the camera's vertical axis."""
    d = dict(seed)
    dR = np.asarray(jse3.so3_exp(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    d["R"] = (dR @ seed["R"]).astype(np.float32)
    d["t"] = (dR @ seed["t"]).astype(np.float32)
    d["last_tracking"] = np.asarray(False)
    d["frame_idx"] = np.asarray(9, np.int32)
    return d


@pytest.mark.parametrize("frame,yaw,fallback", [(1, 0.02, False), (0, 0.6, True)],
                         ids=["guided", "global fallback"])
def test_staged_relocalization_matches_jax(seed_state, frame, yaw, fallback):
    """Frame 1 with a stale pose 0.02 rad off: the guided match at 64 px
    seats a pose.  Frame 0 with a stale pose 0.6 rad off (about 80 px at
    fx=130, a restore to a wrong pose): the guided attempt seats fewer than
    20 inliers, and the global match re-acquires.  (Frame 1 with the wrong
    pose is no parity case: there the global matches are mostly aliases,
    and the reference's DLT hypotheses, whose null vectors come from XLA's
    CPU eigh, vote at most 5 where the port's vote 24, so only the port
    re-acquires.)"""
    jcfg, tcfg = P.configs()
    jcam, tcam = P.cameras()
    state = _lost(seed_state, yaw)
    image = np.stack(_FRAMES[frame:frame + 1])
    _, jys = jtrack_chunk(jcam, jcfg, P.jax_state(state), jnp.asarray(image),
                          jnp.ones(1, bool))
    sampler = P.JaxSampler()
    tstate = VOState.from_numpy(state)
    feats = tvd.extract_features(T(image[0]), tstate.threshold, tcfg.frontend)
    R_pred, t_pred = tvd.se3_compose(tstate.vel_R, tstate.vel_t, tstate.R, tstate.t)
    guided = _reloc_attempt(tcam, tcfg, tstate.map, feats, R_pred, t_pred,
                            P.JaxSampler(), ("reloc", tstate.frame_idx), guided=True)
    assert (int(guided[2]["num_inliers"]) < 20) == fallback
    new, ys = track_chunk(tcam, tcfg, tstate, T(image), [True], sampler)
    # The guided attempt, then (only where it failed) the global one, each
    # drawn under the frame's relocalization key.
    assert sampler.calls == [("reloc", 9)] * (2 if fallback else 1)
    sj, st = np.asarray(jys["summary"])[0], ys["summary"].numpy()[0]
    assert st[_COL["tracking"]] == sj[_COL["tracking"]] == 1
    for name in ("num_matches", "num_inliers"):
        np.testing.assert_allclose(st[_COL[name]], sj[_COL[name]], rtol=0.02, err_msg=name)
    Cj = -np.asarray(jys["R"])[0].T @ np.asarray(jys["t"])[0]
    Ct = -ys["R"][0].numpy().T @ ys["t"][0].numpy()
    assert np.linalg.norm(Ct - Cj) < 2e-3
    Cg = -_POSES[frame][0].T @ _POSES[frame][1]
    assert np.linalg.norm(Ct - Cg) < 0.05
    dR = ys["R"][0].numpy().T @ np.asarray(jys["R"])[0]
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
    # After a relocalization the velocity model restarts from identity.
    np.testing.assert_array_equal(new.vel_R.numpy(), np.eye(3, dtype=np.float32))
    assert bool(new.last_tracking) and int(new.frame_idx) == 10


def test_relocalization_without_staging_goes_global(seed_state):
    _, tcfg = P.configs()
    _, tcam = P.cameras()
    cfg = dataclasses.replace(tcfg, vo=dataclasses.replace(tcfg.vo, staged_reloc=False))
    sampler = P.JaxSampler()
    _, ys = track_chunk(tcam, cfg, VOState.from_numpy(_lost(seed_state, 0.6)),
                        T(np.stack(_FRAMES[:1])), [True], sampler)
    assert sampler.calls == [("reloc", 9)]
    assert ys["summary"][0, _COL["tracking"]] == 1
