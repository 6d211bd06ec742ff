"""The port's Sim(3) group operations against the JAX package's.

Inputs in all four regions of ``_sim3_W`` (theta^2 on either side of its
1e-10 threshold and |sigma| on either side of 1e-5, and both large),
float32, atol 1e-5; exp and log round trips.  The round trips leave out
|sigma| just above 1e-5: there the large-sigma forms cancel in float32
((s - 1) / sigma), and log(exp(xi)) is 3e-3 off in both packages alike.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_parity as P  # noqa: F401  (sets the torch thread count)
from tinyslam_tpu.geometry import sim3 as jsim3
from tinyslam_tpu_torch.geometry import sim3 as tsim3

THETA2 = {"theta2 5e-11": 5e-11, "theta2 2e-10": 2e-10, "theta 0.7": 0.49}
SIGMA = {"sigma 5e-6": 5e-6, "sigma 2e-5": 2e-5, "sigma 0.3": 0.3}
ATOL = 1e-5


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _xi(theta2: float, sigma: float, seed: int = 0, n: int = 16) -> np.ndarray:
    """n tangent vectors at rotation angle^2 theta2 and log scale +-sigma."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    phi = axis * np.sqrt(theta2)
    sig = sigma * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    rho = rng.normal(size=(n, 3))
    return np.concatenate([rho, phi, sig[:, None]], axis=1).astype(np.float32)


REGIONS = [(t, s) for t in THETA2 for s in SIGMA]


@pytest.mark.parametrize("theta2,sigma", REGIONS)
def test_sim3_W_exp_log_match_jax(theta2, sigma):
    xi = _xi(THETA2[theta2], SIGMA[sigma])
    phi, sig = xi[:, 3:6], xi[:, 6]
    np.testing.assert_allclose(tsim3._sim3_W(T(phi), T(sig)).numpy(),
                               np.asarray(jsim3._sim3_W(jnp.asarray(phi), jnp.asarray(sig))),
                               rtol=0, atol=ATOL)
    je = [np.asarray(a) for a in jsim3.sim3_exp(jnp.asarray(xi))]
    te = [a.numpy() for a in tsim3.sim3_exp(T(xi))]
    for a, b in zip(te, je):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tsim3.sim3_log(*(T(a) for a in je)).numpy(),
                               np.asarray(jsim3.sim3_log(*(jnp.asarray(a) for a in je))),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("theta2,sigma", [(t, s) for t, s in REGIONS if s != "sigma 2e-5"])
def test_sim3_exp_log_round_trip(theta2, sigma):
    xi = _xi(THETA2[theta2], SIGMA[sigma], seed=1)
    S = tsim3.sim3_exp(T(xi))
    np.testing.assert_allclose(tsim3.sim3_log(*S).numpy(), xi, rtol=0, atol=ATOL)
    for a, b in zip(tsim3.sim3_exp(tsim3.sim3_log(*S)), S):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)


def test_sim3_group_operations_match_jax():
    a = [np.asarray(x) for x in jsim3.sim3_exp(jnp.asarray(_xi(0.3, 0.2, seed=2)))]
    b = [np.asarray(x) for x in jsim3.sim3_exp(jnp.asarray(_xi(0.8, -0.4, seed=3)))]
    x = np.random.default_rng(4).normal(size=(16, 3)).astype(np.float32)
    J = lambda arrs: [jnp.asarray(v) for v in arrs]   # noqa: E731
    Tt = lambda arrs: [T(v) for v in arrs]            # noqa: E731
    cases = [
        (tsim3.sim3_compose(*Tt(a), *Tt(b)), jsim3.sim3_compose(*J(a), *J(b))),
        (tsim3.sim3_inverse(*Tt(a)), jsim3.sim3_inverse(*J(a))),
        ((tsim3.sim3_apply(*Tt(a), T(x)),), (jsim3.sim3_apply(*J(a), jnp.asarray(x)),)),
        (tsim3.sim3_from_se3(*Tt(a[:2])), jsim3.sim3_from_se3(*J(a[:2]))),
        (tsim3.sim3_to_se3(*Tt(a)), jsim3.sim3_to_se3(*J(a))),
        (tsim3.sim3_identity((4,)), jsim3.sim3_identity((4,))),
    ]
    for got, want in cases:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    # A similarity composed with its inverse is the identity.
    R, t, s = tsim3.sim3_compose(*Tt(a), *tsim3.sim3_inverse(*Tt(a)))
    np.testing.assert_allclose(R.numpy(), np.broadcast_to(np.eye(3), R.shape), atol=ATOL)
    np.testing.assert_allclose(t.numpy(), 0.0, atol=ATOL)
    np.testing.assert_allclose(s.numpy(), 1.0, atol=ATOL)
