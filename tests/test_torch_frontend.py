"""The port's front-end (image ops, FAST, top-k, binned BRIEF, extraction)
against the JAX package's, on the same numpy inputs.

Tolerances: FAST scores atol 1e-5, moments atol 1e-3, blur atol 1e-6 at
every pixel (both packages add in the same order, so these are in practice
exact); integer outputs (NMS on one score map, top-k indices, descriptor
bits) are equal.  Whole-frame extraction: the same count, and xy / angle /
score within 1e-4 and equal descriptors on at least 99% of valid slots
(an ulp of atan2 can move an orientation across a BRIEF bin edge).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_parity as P
from tests.golden import streak16_naive
from tinyslam_tpu.config import FrontendConfig as JFrontendConfig
from tinyslam_tpu.frontend import orb as jorb
from tinyslam_tpu.ops import brief as jbrief, compact as jcompact
from tinyslam_tpu.ops import fast as jfast, image as jimage
from tinyslam_tpu_torch.config import FrontendConfig as TFrontendConfig
from tinyslam_tpu_torch.frontend import orb as torb
from tinyslam_tpu_torch.ops import brief as tbrief, compact as tcompact
from tinyslam_tpu_torch.ops import fast as tfast, fast_cuda, image as timage
from tinyslam_tpu_torch.types import to_numpy

_FRAMES, _POSES, _ROOM = P.orbit(6)


def _img(kind: str) -> np.ndarray:
    if kind == "frame":
        return _FRAMES[2]
    return np.random.default_rng(11).random((P.HEIGHT, P.WIDTH)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 9, 11, 12, 13, 15, 16])
def test_streak_exhaustive(n):
    masks = np.arange(65536, dtype=np.int32)
    got = tfast.detect_streak(torch.from_numpy(masks), n).numpy()
    want = np.array([streak16_naive(i, n) for i in range(65536)])
    np.testing.assert_array_equal(got != 0, want, err_msg=f"n={n}")
    np.testing.assert_array_equal(got, np.asarray(jfast.detect_streak(jnp.asarray(masks), n)))


@pytest.mark.parametrize("kind,threshold", [("frame", 0.06), ("noise", 0.1), ("noise", 0.02)])
def test_fast_maps_match_jax(kind, threshold):
    img = _img(kind)
    js, jm10, jm01 = (np.array(a) for a in jfast.fast_score_map(jnp.asarray(img), threshold))
    ts, tm10, tm01 = (a.numpy() for a in tfast.fast_score_map(torch.from_numpy(img), threshold))
    assert (js > 0).sum() > 20, "test has no power"
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm10, jm10, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm01, jm01, rtol=0, atol=1e-3)
    # NMS of one score map keeps exactly the same pixels.
    np.testing.assert_array_equal(tfast.nms3x3(torch.from_numpy(js)).numpy(),
                                  np.asarray(jfast.nms3x3(jnp.asarray(js))))
    np.testing.assert_allclose(
        timage.gaussian_blur(torch.from_numpy(img), 2.0).numpy(),
        np.asarray(jimage.gaussian_blur(jnp.asarray(img), 2.0)), rtol=0, atol=1e-6)


def test_nms_plateaus_and_edges():
    """Plateaus keep exactly one pixel; pixels at the image edge compare
    against -inf outside the image."""
    s = np.zeros((12, 14), np.float32)
    s[3:5, 3:5] = 2.0          # 2x2 plateau
    s[0, 0] = 1.0              # corner pixel
    s[7, 7:10] = [1.0, 3.0, 3.0]
    got = tfast.nms3x3(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfast.nms3x3(jnp.asarray(s))))
    assert (got > 0).sum() == 3


def test_downsample_and_pyramid_bit_equal():
    img = _img("noise")
    j = jimage.build_pyramid(jnp.asarray(img), 3)[0]
    t = timage.build_pyramid(torch.from_numpy(img), 3)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_fast_wrapper_on_cpu_is_the_plain_version():
    img = torch.from_numpy(_img("frame"))
    before = fast_cuda.LAUNCHES
    got = fast_cuda.fast_score_map_fused(img, torch.tensor(0.06), 20, 9, 2.0)
    want = tfast.fast_maps(img, 0.06, 20, 9, 2.0)
    assert fast_cuda.LAUNCHES == before
    assert len(got) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_select_topk_ties_lowest_index():
    rng = np.random.default_rng(5)
    h, w, k = 30, 40, 25
    score = np.zeros((h, w), np.float32)
    flat = score.reshape(-1)
    idx = rng.choice(h * w, 60, replace=False)
    flat[idx] = rng.choice([0.5, 1.0, 2.0], 60)   # many exact ties
    raw = score + rng.random((h, w)).astype(np.float32) * 0.1
    m10 = rng.normal(size=(h, w)).astype(np.float32)
    m01 = rng.normal(size=(h, w)).astype(np.float32)
    j = jcompact.select_topk(*(jnp.asarray(a) for a in (score, raw, m10, m01)), k, approx=False)
    t = tcompact.select_topk(*(torch.from_numpy(a) for a in (score, raw, m10, m01)), k)
    for key in ("xy", "score", "valid"):
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]), err_msg=key)
    np.testing.assert_allclose(t["angle"].numpy(), np.asarray(j["angle"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bins", [16, 12])
def test_brief_binned_bits_equal(bins):
    rng = np.random.default_rng(9)
    h, w, n = 90, 120, 300
    blurred = rng.random((h, w)).astype(np.float32)
    xy = rng.uniform([0, 0], [w, h], (n, 2)).astype(np.float32)   # incl. clamped patches
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    angle[:20] = (np.arange(20) - 10) * (2 * np.pi / bins)       # on bin centres
    valid = rng.random(n) > 0.1
    want = np.asarray(jbrief.brief_descriptors_binned(
        jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(angle), jnp.asarray(valid), bins=bins))
    got = tbrief.brief_descriptors_binned(
        torch.from_numpy(blurred), torch.from_numpy(xy), torch.from_numpy(angle),
        torch.from_numpy(valid), bins=bins)
    np.testing.assert_array_equal(to_numpy(got, desc=True), want)


@pytest.mark.parametrize("frame", [0, 5])
def test_extract_features_matches_jax(frame):
    img = _FRAMES[frame]
    jcfg, tcfg = JFrontendConfig(**P.FRONTEND), TFrontendConfig(**P.FRONTEND)
    fj = jorb.extract_features(jnp.asarray(img), jnp.float32(0.06), jcfg)
    ft = torb.extract_features(torch.from_numpy(img), 0.06, tcfg)
    assert int(ft.count) == int(fj.count) > 100
    v = np.asarray(fj.valid)
    np.testing.assert_array_equal(ft.valid.numpy(), v)
    np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))
    for key in ("xy", "angle", "score"):
        close = np.abs(getattr(ft, key).numpy() - np.asarray(getattr(fj, key))) <= 1e-4
        close = close.reshape(len(v), -1).all(1)
        assert close[v].mean() >= 0.99, key
    same = (to_numpy(ft.desc, desc=True) == np.asarray(fj.desc)).all(1)
    assert same[v].mean() >= 0.99


def test_extract_uint8_and_rgb_inputs():
    img = np.clip(np.rint(_FRAMES[1] * 255), 0, 255).astype(np.uint8)
    rgb = np.stack([img] * 3, -1)
    tcfg = TFrontendConfig(**P.FRONTEND)
    a = torb.extract_features(torch.from_numpy(img), 0.06, tcfg)
    b = torb.extract_features(torch.from_numpy(rgb), 0.06, tcfg)
    fj = jorb.extract_features(jnp.asarray(img), jnp.float32(0.06), JFrontendConfig(**P.FRONTEND))
    assert int(a.count) == int(fj.count)
    assert abs(int(b.count) - int(a.count)) <= 2     # luma of equal channels rounds


@pytest.mark.parametrize("count", [0, 700, 1536, 1800, 2048])
def test_adapt_threshold_matches_jax(count):
    for th in (0.011, 0.06, 0.49):
        want = jorb.adapt_threshold(jnp.float32(th), jnp.int32(count), 2048, 0.75)
        got = torb.adapt_threshold(torch.tensor(th, dtype=torch.float32),
                                   torch.tensor(count, dtype=torch.int32), 2048, 0.75)
        assert float(got) == float(want)


def test_orb_frontend_adapts_on_device():
    fe = torb.OrbFrontend(TFrontendConfig(**P.FRONTEND, target_fill=0.5))
    feats = fe.extract(torch.from_numpy(_FRAMES[0]))
    assert isinstance(fe._threshold, torch.Tensor) and fe._threshold.dim() == 0
    assert int(feats.count) / 256 > 0.6          # above 1.2 x target: raise it
    assert fe.threshold == float(np.float32(0.06) * np.float32(1.1))


def test_continuous_brief_path_raises():
    cfg = TFrontendConfig(**P.FRONTEND, brief_bins=0)
    with pytest.raises(NotImplementedError, match="continuous-angle BRIEF"):
        torb.extract_features(torch.from_numpy(_FRAMES[0]), 0.06, cfg)
