"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` keeps the JAX set-up of ``tests/conftest.py`` out: the
card's machine cannot import the JAX package, which needs ``flax``.  The
helper is imported as ``torch_parity`` because another ``tests`` package
may shadow this directory there.)  Every output must be bit-equal to the plain
version's: both add in the same order with the same roundings.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_parity as P      # tests/ is on sys.path (pytest's rootdir-less prepend)
from tinyslam_tpu_torch.frontend.orb import extract_features
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models.vo_device import VOState, track_chunk
from tinyslam_tpu_torch.ops import fast, fast_cuda, hamming, match_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(120, 160), (97, 131), (33, 40), (480, 640)])
@pytest.mark.parametrize("border,streak,threshold", [(20, 9, 0.06), (0, 12, 0.02), (3, 9, 0.1)])
def test_fast_kernel_bit_equal(dev, shape, border, streak, threshold):
    rng = np.random.default_rng(shape[0] * 7 + border)
    img = rng.random(shape).astype(np.float32)
    img[: shape[0] // 3] = np.round(img[: shape[0] // 3] * 4) / 4     # flat areas, ties
    x = torch.from_numpy(img).to(dev)
    t = torch.tensor(threshold, dtype=torch.float32, device=dev)
    before = fast_cuda.LAUNCHES
    got = fast_cuda.fast_score_map_fused(x, t, border, streak, 2.0)
    assert fast_cuda.LAUNCHES == before + 1
    want = fast.fast_maps(x, t, border, streak, 2.0)
    for name, g, w in zip(("score_raw", "score_nms", "m10", "m01", "blurred"), got, want):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))
    interior = shape[0] > 2 * border and shape[1] > 2 * border
    assert (int((got[1] > 0).sum()) > 0) == interior


def _match_case(seed, n, m, guided, dev):
    rng = np.random.default_rng(seed)
    da, db = P.rand_desc(rng, n), P.rand_desc(rng, m)
    k = min(n, m)
    db[:k] = P.perturb(rng, da[:k])
    T = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    case = dict(desc_a=T(da.view(np.int32)), valid_a=T(rng.random(n) > 0.1),
                desc_b=T(db.view(np.int32)), valid_b=T(rng.random(m) > 0.1))
    if guided:
        xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
        proj = rng.uniform(0, 200, (m, 2)).astype(np.float32)
        proj[:k] = xy[:k] + rng.normal(0, 5, (k, 2)).astype(np.float32)
        proj[:k:7] = xy[:k:7] + np.array([20.0, 0.0], np.float32)    # on the radius
        case.update(xy_a=T(xy), proj_b=T(proj))
    return case


@pytest.mark.parametrize("n,m", [(2048, 8192), (100, 333), (7, 1), (1, 50), (300, 5000)])
@pytest.mark.parametrize("guided", [False, True])
def test_match_kernel_equal(dev, n, m, guided):
    case = _match_case(n + m, n, m, guided, dev)
    before = match_cuda.LAUNCHES
    got = match_cuda.match_reduce(**case, radius_px=20.0)
    assert match_cuda.LAUNCHES == before + 1
    want = hamming.match_reduce_plain(**case, radius_px=20.0)
    for name, g, w in zip(("best", "second", "idx_b", "col_idx"), got, want):
        assert torch.equal(g, w.to(g.dtype)), name


def test_explicit_pair_mask_raises_on_cuda(dev):
    case = _match_case(0, 16, 32, False, dev)
    with pytest.raises(NotImplementedError):
        match_cuda.match_reduce(**case, pair_mask=torch.ones(16, 32, dtype=torch.bool,
                                                             device=dev))


def test_small_slice_card_matches_cpu(dev):
    """The slice on the card (kernels) and on the CPU (plain versions):
    equal features and tracking flags, matches and inliers within 2%."""
    tcfg = P.torch_config()
    frames, poses, room = P.orbit(5)
    feats = extract_features(torch.from_numpy(frames[0]), 0.06, tcfg.frontend)
    xy = feats.xy[feats.valid].numpy().astype(np.float64)
    X = torch.from_numpy(room.raycast(PinholeCamera.create(**P.CAMERA), *poses[0], xy)
                         .astype(np.float32))
    seed = VOState.seeded(tcfg, feats, X, *(torch.from_numpy(a) for a in poses[0]))
    images = torch.from_numpy(np.stack(frames[1:]))
    cam = PinholeCamera.create(**P.CAMERA)
    _, cpu = track_chunk(cam, tcfg, seed, images, [True] * 4)
    _, gpu = track_chunk(cam, tcfg, VOState.from_numpy(seed.to_numpy(), dev),
                         images.to(dev), [True] * 4)
    sg, sc = gpu["summary"].cpu().numpy(), cpu["summary"].numpy()
    np.testing.assert_array_equal(sg[:, [0, 3, 4, 5]], sc[:, [0, 3, 4, 5]])
    np.testing.assert_allclose(sg[:, 1:3], sc[:, 1:3], rtol=0.02)
    np.testing.assert_allclose(gpu["t"].cpu().numpy(), cpu["t"].numpy(), atol=1e-4)
