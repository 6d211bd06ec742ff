"""The port's Hamming matcher against the XLA branch of the JAX package's
(``match_descriptors(..., use_streaming=False)``): idx_b, dist and valid
are integers and must be equal.  The data generators mirror
tests/test_match_pallas.py: random descriptors with duplicates (ties),
planted near-copies (matches), invalid rows and columns."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu.ops.hamming import hamming_distance_matrix as jdist
from tinyslam_tpu.ops.hamming import match_descriptors as jmatch
from tinyslam_tpu_torch.ops import match_cuda
from tinyslam_tpu_torch.ops.hamming import hamming_distance_matrix as tdist
from tinyslam_tpu_torch.ops.hamming import match_descriptors as tmatch
from tinyslam_tpu_torch.types import from_numpy


def _case(seed, n, m, guided, dup_frac=0.2):
    rng = np.random.default_rng(seed)
    da = P.rand_desc(rng, n, dup_frac)
    db = P.rand_desc(rng, m, dup_frac)
    k = min(n, m)
    db[:k] = P.perturb(rng, da[:k])
    case = {"desc_a": da, "valid_a": rng.random(n) > 0.1,
            "desc_b": db, "valid_b": rng.random(m) > 0.1}
    if guided:
        xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
        proj = rng.uniform(0, 200, (m, 2)).astype(np.float32)
        proj[:k] = xy[:k] + rng.normal(0, 5, (k, 2)).astype(np.float32)
        proj[k:k + 3] = 1e7                       # parked (behind the camera)
        case.update(xy_a=xy, proj_b=proj)
    return case


def _compare(case, **kw):
    want = jmatch(*(jnp.asarray(case[k]) for k in ("desc_a", "valid_a", "desc_b", "valid_b")),
                  xy_a=None if "xy_a" not in case else jnp.asarray(case["xy_a"]),
                  proj_b=None if "proj_b" not in case else jnp.asarray(case["proj_b"]),
                  use_streaming=False, **kw)
    got = tmatch(*(from_numpy(case[k]) for k in ("desc_a", "valid_a", "desc_b", "valid_b")),
                 xy_a=None if "xy_a" not in case else from_numpy(case["xy_a"]),
                 proj_b=None if "proj_b" not in case else from_numpy(case["proj_b"]), **kw)
    for key in ("idx_b", "dist", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    return np.asarray(want["valid"])


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("ratio", [0.7, 0.9])
def test_match_descriptors_equal(guided, ratio):
    case = _case(7, 96, 320, guided)
    valid = _compare(case, max_distance=80, ratio=ratio, cross_check=True,
                     radius_px=30.0 if guided else 0.0)
    assert valid.sum() > 5, "test has no power"


@pytest.mark.parametrize("cross_check", [False, True])
def test_heavy_ties_and_all_invalid_rows(cross_check):
    case = _case(3, 64, 128, False, dup_frac=0.6)
    case["valid_a"][:10] = False                 # whole rows at BIG
    case["valid_b"][:] = True
    case["desc_b"][64:] = case["desc_b"][:64]    # every column twice
    _compare(case, max_distance=128, ratio=0.95, cross_check=cross_check)


@pytest.mark.parametrize("guided", [False, True])
def test_single_map_point(guided):
    case = _case(5, 40, 1, guided)
    case["valid_b"][:] = True
    _compare(case, max_distance=256, ratio=1.0, radius_px=50.0 if guided else 0.0)


def test_gate_radius_boundary():
    """Pairs exactly on the radius are outside the gate (strict <)."""
    rng = np.random.default_rng(2)
    da = P.rand_desc(rng, 8, 0)
    case = {"desc_a": da, "valid_a": np.ones(8, bool), "desc_b": da.copy(),
            "valid_b": np.ones(8, bool),
            "xy_a": np.zeros((8, 2), np.float32),
            "proj_b": np.array([[20, 0], [0, 20], [12, 16], [19.999, 0],
                                [20.001, 0], [-20, 0], [0, -19.9], [14.142, 14.142]],
                               np.float32)}
    valid = _compare(case, max_distance=64, ratio=0.9, radius_px=20.0)
    assert valid.tolist() == [False, False, False, True, False, False, True, True]


def test_explicit_pair_mask_on_cpu():
    case = _case(9, 48, 96, False)
    mask = np.random.default_rng(1).random((48, 96)) > 0.3
    want = jmatch(*(jnp.asarray(case[k]) for k in ("desc_a", "valid_a", "desc_b", "valid_b")),
                  pair_mask=jnp.asarray(mask), use_streaming=False)
    got = tmatch(*(from_numpy(case[k]) for k in ("desc_a", "valid_a", "desc_b", "valid_b")),
                 pair_mask=torch.from_numpy(mask))
    for key in ("idx_b", "dist", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_distance_matrix_and_cpu_dispatch():
    rng = np.random.default_rng(4)
    a, b = P.rand_desc(rng, 33, 0), P.rand_desc(rng, 65, 0)
    np.testing.assert_array_equal(tdist(from_numpy(a), from_numpy(b)).numpy(),
                                  np.asarray(jdist(jnp.asarray(a), jnp.asarray(b))))
    before = match_cuda.LAUNCHES
    best, second, idx, col = match_cuda.match_reduce(
        from_numpy(a), torch.ones(33, dtype=torch.bool),
        from_numpy(b), torch.ones(65, dtype=torch.bool))
    assert match_cuda.LAUNCHES == before
    assert best.dtype == second.dtype == idx.dtype == col.dtype == torch.int32
    assert best.shape == (33,) and col.shape == (65,)
