"""The port's continuous-angle BRIEF (``ops/brief.py:brief_descriptors``),
its C-library trigonometry (``ops/fmath.py``) and the front-end's
continuous-BRIEF path, against the JAX package's on the same numpy inputs.

Every comparison is exact: descriptor words, angles, sines and cosines
bit for bit.  The levels are seeded: uniform noise, and noise quantized to
four grey levels, whose many near-equal samples make a bit turn on the
last rounding of the bilinear blend.  Positions reach 5 px beyond the
border, where the samples clamp.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu.config import FrontendConfig as JFrontendConfig
from tinyslam_tpu.frontend import orb as jorb
from tinyslam_tpu.ops import brief as jbrief
from tinyslam_tpu_torch.config import FrontendConfig as TFrontendConfig
from tinyslam_tpu_torch.frontend import orb as torb
from tinyslam_tpu_torch.ops import brief as tbrief
from tinyslam_tpu_torch.ops.fmath import atan2f, sincosf
from tinyslam_tpu_torch.types import to_numpy

_FRAMES, _, _ = P.orbit(6)


def _level(seed: int, quantized: bool, n: int = 2000):
    rng = np.random.default_rng(seed)
    h, w = 90, 120
    img = rng.random((h, w))
    if quantized:
        img = np.floor(img * 4) / 4
    xy = rng.uniform([-5, -5], [w + 5, h + 5], (n, 2)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    angle[:8] = np.float32([0.0, np.pi, -np.pi, np.pi / 2, -np.pi / 2, 0.75, -0.75, 1e-5])
    valid = rng.random(n) > 0.1
    return img.astype(np.float32), xy, angle, valid


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("seed,quantized", [(0, False), (1, False), (2, True), (3, True)])
def test_brief_descriptors_bits_equal_jax(seed, quantized, interpolate):
    args = _level(seed, quantized)
    want = np.asarray(jbrief.brief_descriptors(*(jnp.asarray(a) for a in args),
                                               interpolate=interpolate))
    got = to_numpy(tbrief.brief_descriptors(*(torch.from_numpy(a) for a in args),
                                            interpolate=interpolate), desc=True)
    np.testing.assert_array_equal(got, want)
    valid = args[3]
    assert (got[~valid] == 0).all() and (got[valid] != 0).any(axis=1).mean() > 0.99


def test_atan2f_bits_equal_jax():
    rng = np.random.default_rng(4)
    y = np.concatenate([rng.normal(size=20000), rng.normal(size=2000) * 1e-3,
                        [0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 3.0, 1e-30, -1e30, 2.0]])
    x = np.concatenate([rng.normal(size=20000), rng.normal(size=2000) * 1e3,
                        [0.0, 0.0, -0.0, -0.0, 0.0, -0.0, 1.0, 1e30, 1e-30, -1.0]])
    y, x = y.astype(np.float32), x.astype(np.float32)
    got = atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(jnp.arctan2(y, x)).view(np.int32))


def test_sincosf_bits_equal_jax():
    a = np.concatenate([np.random.default_rng(5).uniform(-np.pi, np.pi, 20000),
                        [0.0, -0.0, 1e-5, 0.75, -0.75, np.pi / 4, np.pi, -np.pi]])
    a = a.astype(np.float32)
    s, c = sincosf(torch.from_numpy(a))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jnp.sin(a)))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jnp.cos(a)))


@pytest.mark.parametrize("frame", [0, 5])
@pytest.mark.parametrize("brief", [dict(), dict(brief_bins=0),
                                   dict(interpolate_descriptors=True),
                                   dict(brief_bins=0, interpolate_descriptors=True)])
def test_front_end_equals_jax_eager(brief, frame):
    """The whole extraction, every field bit for bit, against the JAX
    package's eager front-end, binned and continuous."""
    img = _FRAMES[frame]
    fj = jorb.extract_features(jnp.asarray(img), jnp.float32(0.06),
                               JFrontendConfig(**P.FRONTEND, **brief))
    ft = torb.extract_features(torch.from_numpy(img), 0.06,
                               TFrontendConfig(**P.FRONTEND, **brief))
    assert int(ft.count) > 100
    for k in P.FEATURE_FIELDS:
        np.testing.assert_array_equal(to_numpy(getattr(ft, k), desc=k == "desc"),
                                      np.asarray(getattr(fj, k)), err_msg=k)
