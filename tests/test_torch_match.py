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
from tinyslam_tpu_torch.ops.hamming import BIG, gate_radius2, match_reduce_plain
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


def _kernel_epilogue(desc_a, valid_a, desc_b, valid_b, xy_a=None, proj_b=None,
                     radius_px=0.0, tps=1):
    """The arithmetic of csrc/match.cu's epilogue and merge, in plain torch,
    for column slices of ``tps`` tiles.  The matrix is padded to whole tiles
    (128 rows, 64 columns) of failing pairs.  In the CTA the codes are 16
    bits: a pair of dot ``dot`` (256 - 2 x distance) gives the row code
    16384 + k - 64 dot, k = 8 (tile - first tile of the slice) + j for
    column 64 tile + 8 j + 2 lr + e, and the column code 16384 + rl - 64 dot,
    rl the row within its tile of 128.  Guided, a failing pair's dot is
    -766 (distance 511); unguided, a code is raised to 65408 + k (65408 +
    rl) where the column (row) is invalid, and an invalid row's or column's
    outputs are set in the merge.  Per row, the two smallest row codes of
    each thread's columns (one slice, lr and e), widened to
    (BIG if 511 else d) << cbits | column, then the two smallest of those;
    per column the smallest column code of each row tile, widened to
    d << nshift | row, then the smallest over the tiles."""
    n, m = desc_a.shape[0], desc_b.shape[0]
    rt, ct = match_cuda.ROW_TILE, match_cuda.COL_TILE
    n_pad, m_pad = -(-n // rt) * rt, -(-m // ct) * ct
    ns, cb = match_cuda._shift_for(n_pad), match_cuda._shift_for(m_pad)
    dot = torch.zeros((n_pad, m_pad), dtype=torch.long)
    dot[:n, :m] = 256 - 2 * tdist(desc_a, desc_b).long()
    va, vb = torch.zeros(n_pad, dtype=torch.bool), torch.zeros(m_pad, dtype=torch.bool)
    va[:n], vb[:m] = valid_a, valid_b
    cols, rows = torch.arange(m_pad), torch.arange(n_pad)
    tile, lr, e = cols // ct, (cols % 8) // 2, cols % 2
    first = tile // tps * tps
    k = 8 * (tile - first) + (cols % ct) // 8
    rl = rows % rt
    if xy_a is not None:
        ok = va[:, None] & vb[None, :]
        du = xy_a[:, None, 0] - proj_b[None, :, 0]
        dv = xy_a[:, None, 1] - proj_b[None, :, 1]
        ok[:n, :m] &= du * du + dv * dv < gate_radius2(radius_px)
        dot = torch.where(ok, dot, -766)
        rcode = 16384 + k[None, :] - 64 * dot
        ccode = 16384 + rl[:, None] - 64 * dot
    else:
        rcode = torch.maximum(16384 + k[None, :] - 64 * dot,
                              torch.where(vb, 0, 65408 + k)[None, :])
        ccode = torch.maximum(16384 + rl[:, None] - 64 * dot,
                              torch.where(va, 0, 65408 + rl)[:, None])
    assert int(k.max()) < 128 and 0 <= int(rcode.min()) and int(rcode.max()) < 65536
    assert 0 <= int(ccode.min()) and int(ccode.max()) < 65536

    def widen(code, shift, index):
        d = code >> 7
        return (torch.where(d == 511, BIG, d) << shift) | index

    cands = []
    for key in torch.unique(first * 8 + lr * 2 + e):       # one thread's columns
        sel = torch.nonzero(first * 8 + lr * 2 + e == key)[:, 0]
        two = rcode[:, sel].sort(dim=1).values[:, :2]
        kk = two & 127
        col = (first[sel[0]] + (kk >> 3)) * ct + 8 * (kk & 7) + 2 * lr[sel[0]] + e[sel[0]]
        cands.append(widen(two, cb, col))
    lo_hi = torch.cat(cands, 1).sort(dim=1).values[:n, :2]
    assert int(lo_hi.max()) < 2**31 - 1
    best = torch.where(valid_a, lo_hi[:, 0] >> cb, BIG)
    second = torch.where(valid_a, lo_hi[:, 1] >> cb, BIG)
    idx = torch.where(valid_a, lo_hi[:, 0] & ((1 << cb) - 1), 0)
    per_tile = ccode.view(-1, rt, m_pad).min(dim=1).values          # (row tiles, m_pad)
    tile_row0 = (torch.arange(per_tile.shape[0]) * rt)[:, None]
    col = widen(per_tile, ns, tile_row0 + (per_tile & 127)).min(dim=0).values[:m]
    col_idx = torch.where(valid_b, col & ((1 << ns) - 1), 0)
    return best, second, idx, col_idx


def _epilogue_cases():
    ties = _case(3, 64, 128, False, dup_frac=0.6)
    ties["valid_a"][:10] = False                 # whole rows at BIG
    ties["desc_b"][64:] = ties["desc_b"][:64]    # every column twice
    gated_out = _case(8, 50, 70, True)
    gated_out["proj_b"][:] = 1e4                 # every pair outside the gate
    rng = np.random.default_rng(2)
    da = P.rand_desc(rng, 8, 0)
    radius = {"desc_a": da, "valid_a": np.ones(8, bool), "desc_b": da.copy(),
              "valid_b": np.ones(8, bool), "xy_a": np.zeros((8, 2), np.float32),
              "proj_b": np.array([[20, 0], [0, 20], [12, 16], [19.999, 0], [20.001, 0],
                                  [-20, 0], [0, -19.9], [14.142, 14.142]], np.float32)}
    invalid = _case(6, 33, 40, False)
    invalid["valid_a"][:] = False                # every row invalid
    return {"random guided": (_case(7, 96, 320, True), 30.0),
            "ragged 300x333 unguided": (_case(1, 300, 333, False), 0.0),
            "heavy ties": (ties, 0.0),
            "all rows invalid": (invalid, 0.0),
            "M=1 guided": (_case(5, 40, 1, True), 50.0),
            "M=1 unguided": (_case(5, 40, 1, False), 0.0),
            "every pair gated out": (gated_out, 20.0),
            "pairs on the radius": (radius, 20.0)}


_EPILOGUE_CASES = _epilogue_cases()


@pytest.mark.parametrize("tps", [1, 2, 16])
@pytest.mark.parametrize("name", list(_EPILOGUE_CASES))
def test_kernel_epilogue_arithmetic_equals_plain(name, tps):
    """The packed-code arithmetic of the tensor-core kernel (16-bit codes,
    two columns to a register, widened to 32 bits for the merge; padded
    tiles included; two smallest per row over every thread's columns and
    column slices of ``tps`` tiles, smallest per column over row tiles of
    128) gives exactly ``match_reduce_plain``'s four outputs."""
    case, radius = _EPILOGUE_CASES[name]
    t = {k: from_numpy(v) for k, v in case.items()}
    got = _kernel_epilogue(**t, radius_px=radius, tps=tps)
    want = match_reduce_plain(**t, radius_px=radius)
    for label, g, w in zip(("best", "second", "idx_b", "col_idx"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=label)


@pytest.mark.parametrize("row_tiles,col_tiles,want", [
    (16, 128, (16, 8)),     # 2048 x 8192: 2 CTAs on the busiest SM, not 3
    (16, 32, (16, 2)),      # 2048 x 2048
    (1, 6, (6, 1)),         # 100 x 333
    (3, 79, (79, 1)),       # 300 x 5000
    (17, 128, (22, 6)),     # 2049 x 8192: 3 an SM beat 2 of 8 tiles
    (16, 1600, (100, 16)),  # no split fits one wave: the longest slices
    (64, 128, (8, 16)),     # 4 sequences of 2048 x 8192: none fits either
    (128, 128, (8, 16)),    # 8 sequences
])
def test_grid_split(row_tiles, col_tiles, want):
    """The K2 grid on 132 SMs holding 3 CTAs each: every column tile in
    exactly one slice, at most 16 tiles a slice (the 7-bit slot of the row
    codes), every CTA resident at once where a split allows it."""
    sms, per_sm = 132, 3
    slices, tps = match_cuda.grid_split(row_tiles, col_tiles, sms, per_sm)
    assert (slices, tps) == want
    assert 1 <= tps <= match_cuda.MAX_TPS and (slices - 1) * tps < col_tiles <= slices * tps
