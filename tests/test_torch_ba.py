"""The port's triangulation, BA residuals and Schur-LM bundle adjustment
against the JAX package's.

Tolerances: ``triangulate``/``depths`` atol 1e-5; residuals and Jacobians
rtol 1e-5 (atol 1e-3 px, 1e-2 on Jacobian entries of up to ~500 px/m);
``bundle_adjust`` on ``tests/test_ba.py``'s window problem (K=8, L=300,
some ``point_valid`` false, gauge slots 0 and 1) over the configured 6 LM
iterations: R and t atol 1e-4, X atol 1e-3, cost rtol 1e-3 and the final
damping ``lam`` equal (the same accept decisions; once converged, about
the 8th iteration, accepts turn on float32 noise in either package).  The
nanmedian helper equals ``jnp.nanmedian`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_parity as P  # noqa: F401  (sets the torch thread count)
from tests.test_ba import _perturb, _window_problem
from tinyslam_tpu.backend.ba import bundle_adjust as jbundle_adjust
from tinyslam_tpu.backend.residuals import reprojection_residuals as jresiduals
from tinyslam_tpu.geometry import epipolar as jepi
from tinyslam_tpu.geometry.se3 import se3_exp as jse3_exp
from tinyslam_tpu_torch.backend import bundle_adjust
from tinyslam_tpu_torch.backend.ba import ba_normal_blocks, schur_reduce
from tinyslam_tpu_torch.backend.residuals import reprojection_residuals
from tinyslam_tpu_torch.geometry import epipolar as tepi
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.ops.stats import nanmedian


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))      # a writable copy


def _tcam(jcam) -> PinholeCamera:
    return PinholeCamera.create(float(jcam.fx), float(jcam.fy), float(jcam.cx),
                                float(jcam.cy))


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_and_depths_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 200
    X = (rng.uniform(-1, 1, (n, 3)) * [2.0, 1.5, 1.0] + [0, 0, 4]).astype(np.float32)
    # A baseline half the depth: at small parallax the 3x3 normal equations
    # are ill-conditioned, and float32 itself carries ~1e-4 of error there.
    xi = np.array([[0, 0, 0, 0, 0, 0], [2.0, 0.1, 0.5, 0.0, -0.45, 0.0]], np.float32)
    R, t = (np.asarray(a) for a in jse3_exp(jnp.asarray(xi)))
    x = [(X @ R[k].T + t[k]) for k in range(2)]
    x = [(p[:, :2] / p[:, 2:]).astype(np.float32) + rng.normal(0, 1e-3, (n, 2)).astype(np.float32)
         for p in x]
    Xj = np.asarray(jepi.triangulate(*(jnp.asarray(a) for a in (R[0], t[0], x[0], R[1], t[1], x[1]))))
    Xt = tepi.triangulate(*(T(a) for a in (R[0], t[0], x[0], R[1], t[1], x[1]))).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(Xt, X, rtol=0, atol=0.1)
    zj = np.asarray(jepi.depths(jnp.asarray(R[1]), jnp.asarray(t[1]), jnp.asarray(Xj)))
    zt = tepi.depths(T(R[1]), T(t[1]), T(Xj)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-5)


def _problem(seed, K=8, L=300):
    rng = np.random.default_rng(seed)
    jcam, X, R_gt, t_gt, z, mask = _window_problem(rng, K=K, L=L)
    R0, t0, X0 = _perturb(rng, R_gt, t_gt, X)
    point_valid = np.ones(L, bool)
    point_valid[rng.choice(L, 12, replace=False)] = False
    pose_free = np.ones(K, bool)
    pose_free[:2] = False
    return jcam, R0, t0, X0.astype(np.float32), z, mask, pose_free, point_valid


def test_reprojection_residuals_match_jax():
    jcam, R, t, X, z, mask, _, _ = _problem(4, K=5, L=120)
    X[:5] = -X[:5] * 10.0                       # some points behind cameras
    j = jresiduals(jcam, *(jnp.asarray(a) for a in (R, t, X, z, mask)))
    tt = reprojection_residuals(_tcam(jcam), *(T(a) for a in (R, t, X, z, mask)))
    np.testing.assert_array_equal(tt[3].numpy(), np.asarray(j[3]))
    for a, b, atol in zip(tt[:3], j[:3], (1e-3, 1e-2, 1e-2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=atol)


@pytest.fixture(scope="module")
def ba_pair():
    jcam, R0, t0, X0, z, mask, pose_free, point_valid = _problem(0)
    j = jbundle_adjust(jcam, *(jnp.asarray(a) for a in (R0, t0, X0, z, mask, pose_free)),
                       point_valid=jnp.asarray(point_valid), max_iters=6)
    t = bundle_adjust(_tcam(jcam), *(T(a) for a in (R0, t0, X0, z, mask, pose_free)),
                      point_valid=T(point_valid), max_iters=6)
    return {"j": {k: np.asarray(v) for k, v in j.items()},
            "t": {k: v.numpy() for k, v in t.items()},
            "X0": X0, "R0": R0, "t0": t0, "point_valid": point_valid}


def test_bundle_adjust_matches_jax(ba_pair):
    j, t = ba_pair["j"], ba_pair["t"]
    assert float(j["cost"]) < 0.05 * float(j["initial_cost"])
    np.testing.assert_allclose(t["R"], j["R"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["t"], j["t"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["X"], j["X"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t["initial_cost"], j["initial_cost"], rtol=1e-4)
    np.testing.assert_allclose(t["cost"], j["cost"], rtol=1e-3)
    assert t["lam"] == j["lam"]


def test_bundle_adjust_keeps_gauge_and_invalid_points(ba_pair):
    t = ba_pair["t"]
    np.testing.assert_array_equal(t["R"][:2], ba_pair["R0"][:2])
    np.testing.assert_array_equal(t["t"][:2], ba_pair["t0"][:2])
    bad = ~ba_pair["point_valid"]
    np.testing.assert_array_equal(t["X"][bad], ba_pair["X0"][bad])


def test_non_positive_definite_system_rejects_the_step():
    """A negative damping makes S indefinite: cholesky_ex reports it, and
    the step is rejected with R, t and X unchanged (where the JAX package
    gets NaN from its Cholesky and rejects the NaN step)."""
    jcam, R0, t0, X0, z, mask, pose_free, point_valid = _problem(1, K=5, L=150)
    cam = _tcam(jcam)
    args = [T(a) for a in (R0, t0, X0, z, mask, pose_free)]
    lam = torch.tensor(-10.0)
    U, gc, V, gp, W, _, _ = ba_normal_blocks(cam, *args[:5], 5.0)
    S, _, _ = schur_reduce(U, gc, V, gp, W, lam, args[5])
    assert int(torch.linalg.cholesky_ex(S + 1e-8 * torch.eye(S.shape[0])).info) > 0
    out = bundle_adjust(cam, *args, point_valid=T(point_valid), max_iters=1, lam0=-10.0)
    np.testing.assert_array_equal(out["R"].numpy(), R0)
    np.testing.assert_array_equal(out["t"].numpy(), t0)
    np.testing.assert_array_equal(out["X"].numpy(), X0)
    assert float(out["cost"]) == float(out["initial_cost"])
    assert float(out["lam"]) == np.float32(1e-9)           # -100 clipped


_NAN = np.nan


@pytest.mark.parametrize("x", [
    [1.0, 2.0, _NAN, 4.0, 3.0],                  # even count: 2.5
    [5.0, _NAN, 1.0],                             # odd count
    [_NAN, _NAN, _NAN],                           # all NaN
    [[3.0, 1.0, _NAN, 2.0], [_NAN] * 4, [4.0, 4.0, 1.0, 0.5], [7.0, _NAN, _NAN, _NAN]],
])
def test_nanmedian_matches_jnp(x):
    a = np.asarray(x, np.float32)
    want = np.asarray(jnp.nanmedian(jnp.asarray(a), axis=-1))
    got = nanmedian(T(a), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)


def test_nanmedian_random_rows_match_jnp():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(64, 50)).astype(np.float32)
    a[rng.random(a.shape) < 0.6] = np.nan
    a[3] = np.nan
    np.testing.assert_array_equal(nanmedian(T(a), dim=1).numpy(),
                                  np.asarray(jnp.nanmedian(jnp.asarray(a), axis=1)))
