"""The plain version of the triangulation's duplicate test and local depth
band (``tinyslam_tpu_torch/ops/dupband_cuda.py:dup_band_plain``, which the
CUDA kernel of ``csrc/dupband.cu`` must equal bit for bit) against a
numpy reference: Hamming distances from ``np.unpackbits``, squared pixel
distances in float32, medians from ``np.sort``.  The card's tests of the
kernel are in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_parity as P
from tinyslam_tpu_torch.ops.dupband_cuda import dup_band, dup_band_plain


def reference(xy, desc, u, v, z, mdesc, valid, in_view, r):
    """(dup, z_local, n_neigh) in numpy, row by row."""
    bits = lambda d: np.unpackbits(d.view(np.uint8), axis=-1)    # noqa: E731
    ham = (bits(desc)[:, None, :] != bits(mdesc)[None, :, :]).sum(-1)
    du = xy[:, None, 0] - u[None, :]
    dv = xy[:, None, 1] - v[None, :]
    d2 = du * du + dv * dv                         # float32, one rounding a step
    similar = (ham <= 40) & valid[None, :]
    if r > 0:
        similar &= (d2 < np.float32(r * r)) & in_view[None, :]
    neigh = (d2 < np.float32(1600.0)) & in_view[None, :]
    z_local = np.full(len(xy), np.nan, np.float32)
    for i in range(len(xy)):
        s = np.sort(z[neigh[i]][~np.isnan(z[neigh[i]])])
        if len(s):
            z_local[i] = (s[(len(s) - 1) // 2] + s[len(s) // 2]) * np.float32(0.5)
    return similar.any(1), z_local, neigh.sum(1).astype(np.int32)


def run_both(case, r):
    args = [case[k] for k in P.DUPBAND_ARGS]
    got = dup_band_plain(*map(torch.from_numpy, args), r)
    return [g.numpy() for g in got], reference(*args, r)


def assert_same(got, want):
    dup, z_local, n_neigh = got
    np.testing.assert_array_equal(dup, want[0])
    np.testing.assert_array_equal(n_neigh, want[2])
    assert n_neigh.dtype == np.int32 and dup.dtype == bool and z_local.dtype == np.float32
    np.testing.assert_array_equal(z_local.view(np.int32), want[1].view(np.int32))  # NaN too


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("r", [48.0, 20.5, 0.0])
def test_plain_matches_numpy_on_random_scenes(seed, r):
    got, want = run_both(P.dupband_scene(seed), r)
    assert_same(got, want)
    assert want[0].any() and (want[2] >= 5).any()       # the scenes exercise both tests


def test_plain_matches_numpy_on_a_crowded_scene():
    """Rows with more neighbours than the kernel's list holds, tied and
    NaN depths among them."""
    got, want = run_both(P.dupband_scene(7, n=64, m=2048, cluster=900), 48.0)
    assert_same(got, want)
    assert (want[2] > 512).sum() >= 4


@pytest.mark.parametrize("r", [48.0, 0.0])
@pytest.mark.parametrize("kind", sorted(P.DUPBAND_EDGES))
def test_plain_edge_cases(kind, r):
    got, want = run_both(P.dupband_edge(kind), r)
    assert_same(got, want)
    dup48, dup0, n_neigh, z_local = P.DUPBAND_EDGES[kind][1]
    assert bool(got[0][0]) == (dup48 if r > 0 else dup0)
    assert int(got[2][0]) == n_neigh
    np.testing.assert_array_equal(got[1][0], np.float32(z_local))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = [torch.from_numpy(P.dupband_scene(9)[k]) for k in P.DUPBAND_ARGS]
    for g, w in zip(dup_band(*args, 48.0), dup_band_plain(*args, 48.0)):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.int32) if g.is_floating_point()
                                                  else g, w.view(torch.int32)
                                                  if w.is_floating_point() else w)
