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

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as P      # tests/ is on sys.path (pytest's rootdir-less prepend)
from tinyslam_tpu_torch.frontend.orb import extract_features
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models.vo_device import DeviceVO, VOState, track_chunk
from tinyslam_tpu_torch.ops import dupband_cuda, fast, fast_cuda, hamming, match_cuda
from tinyslam_tpu_torch.utils.draws import Sampler, seed_word

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(120, 160), (97, 131), (33, 40), (480, 640),
                                   (480, 752)])
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


@pytest.mark.parametrize("shape,levels", [((480, 640), 4), ((480, 752), 4), ((97, 131), 3)])
def test_fast_pyramid_kernel_bit_equal(dev, shape, levels):
    """One launch over every level; rows of 131 are not 16-byte aligned and
    take the kernel's clamped scalar path; EuRoC's 752 gives levels 376,
    188 and 94 wide."""
    from tinyslam_tpu_torch.ops.image import build_pyramid

    rng = np.random.default_rng(sum(shape))
    img = rng.random(shape).astype(np.float32)
    img[: shape[0] // 3] = np.round(img[: shape[0] // 3] * 4) / 4     # flat areas, ties
    pyr = build_pyramid(torch.from_numpy(img).to(dev), levels)
    t = torch.tensor(0.06, dtype=torch.float32, device=dev)
    before = fast_cuda.LAUNCHES
    got = fast_cuda.fast_pyramid_maps(pyr, t, 20, 9, 2.0)
    assert fast_cuda.LAUNCHES == before + 1
    for level, maps in zip(pyr, got):
        want = fast.fast_maps(level, t, 20, 9, 2.0)
        for name, g, w in zip(("score_raw", "score_nms", "m10", "m01", "blurred"), maps, want):
            assert torch.equal(g, w), (tuple(level.shape), name,
                                       float((g - w).abs().max()))


@pytest.mark.parametrize("shape,levels,batch", [((480, 640), 4, 8), ((480, 752), 4, 3),
                                                ((97, 131), 3, 2), ((480, 640), 4, 1)])
def test_fast_pyramid_kernel_batched_bit_equal(dev, shape, levels, batch):
    """One launch over B frames x every level ((B, H_l, W_l) levels, the
    frame the grid's second dimension): every map of every level of every
    frame equals the plain version, and frame 0 equals the single-frame
    (H, W) launch."""
    from tinyslam_tpu_torch.ops.image import build_pyramid

    rng = np.random.default_rng(sum(shape) + batch)
    img = rng.random((batch, *shape)).astype(np.float32)
    img[:, : shape[0] // 3] = np.round(img[:, : shape[0] // 3] * 4) / 4
    pyr = build_pyramid(torch.from_numpy(img).to(dev), levels)
    t = torch.tensor(0.06, dtype=torch.float32, device=dev)
    before = fast_cuda.LAUNCHES
    got = fast_cuda.fast_pyramid_maps(pyr, t, 20, 9, 2.0)
    assert fast_cuda.LAUNCHES == before + 1
    names = ("score_raw", "score_nms", "m10", "m01", "blurred")
    for level, maps in zip(pyr, got):
        for b in range(batch):
            want = fast.fast_maps(level[b], t, 20, 9, 2.0)
            for name, g, w in zip(names, maps, want):
                assert torch.equal(g[b], w), (tuple(level.shape), b, name,
                                              float((g[b] - w).abs().max()))
    single = fast_cuda.fast_pyramid_maps([level[0] for level in pyr], t, 20, 9, 2.0)
    for maps, one in zip(got, single):
        for g, s in zip(maps, one):
            assert torch.equal(g[0], s)


@pytest.mark.parametrize("shape,levels,thresholds", [((480, 640), 4, (0.03, 0.06, 0.09, 0.12)),
                                                     ((97, 131), 3, (0.02, 0.1))])
def test_fast_pyramid_kernel_threshold_a_frame(dev, shape, levels, thresholds):
    """A (B,) threshold: one launch, each frame's maps equal to the plain
    version's at that frame's threshold."""
    from tinyslam_tpu_torch.ops.image import build_pyramid

    batch = len(thresholds)
    rng = np.random.default_rng(sum(shape) + 3 * batch)
    img = rng.random((batch, *shape)).astype(np.float32)
    pyr = build_pyramid(torch.from_numpy(img).to(dev), levels)
    t = torch.tensor(thresholds, dtype=torch.float32, device=dev)
    before = fast_cuda.LAUNCHES
    got = fast_cuda.fast_pyramid_maps(pyr, t, 20, 9, 2.0)
    assert fast_cuda.LAUNCHES == before + 1
    for level, maps in zip(pyr, got):
        for b in range(batch):
            want = fast.fast_maps(level[b], t[b], 20, 9, 2.0)
            for g, w in zip(maps, want):
                assert torch.equal(g[b], w), (tuple(level.shape), b)
    corners = [int((got[0][1][b] > 0).sum()) for b in range(batch)]
    assert corners == sorted(corners, reverse=True) and corners[0] > corners[-1]


def test_extract_batch_card_equals_per_frame(dev):
    """The batched extraction on the card: one K1 launch for 3 frames, each
    frame's features equal to ``extract_features`` on the card and on the
    CPU plain path."""
    from tinyslam_tpu_torch.frontend.orb import extract_batch

    cfg = P.torch_config().frontend
    frames = torch.from_numpy(np.stack(P.orbit(3)[0]))
    before = fast_cuda.LAUNCHES
    batch = extract_batch(frames.to(dev), cfg.threshold, cfg)
    assert fast_cuda.LAUNCHES == before + 1
    for i in range(3):
        for ref in (extract_features(frames[i].to(dev), cfg.threshold, cfg),
                    extract_features(frames[i], cfg.threshold, cfg)):
            for f in dataclasses.fields(ref):
                assert torch.equal(getattr(batch, f.name)[i].cpu(),
                                   getattr(ref, f.name).cpu()), (i, f.name)


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


@pytest.mark.parametrize("n,m", [(2048, 8192), (2048, 2048), (100, 333), (7, 1), (1, 50),
                                 (300, 5000), (130, 70), (2047, 8191)])
@pytest.mark.parametrize("guided", [False, True])
def test_match_kernel_equal(dev, n, m, guided):
    case = _match_case(n + m, n, m, guided, dev)
    before = match_cuda.LAUNCHES
    got = match_cuda.match_reduce(**case, radius_px=20.0)
    assert match_cuda.LAUNCHES == before + 1
    want = hamming.match_reduce_plain(**case, radius_px=20.0)
    for name, g, w in zip(("best", "second", "idx_b", "col_idx"), got, want):
        assert torch.equal(g, w.to(g.dtype)), name


def test_match_scratch_growth_keeps_captured_graphs_right(dev):
    """K2's merge counters and column codes are one scratch buffer a
    device, which a larger launch replaces.  A graph captured before keeps
    the old address: after the growth, and after new tensors have taken
    whatever memory was freed, its replays still equal the plain version."""
    from tinyslam_tpu_torch.utils.cuda_graph import Program

    case = _match_case(11, 2048, 8192, True, dev)
    prog = Program(lambda s: match_cuda.match_reduce(**s, radius_px=20.0), case, dev)
    counters, colcode = match_cuda._SCRATCH[dev if dev.index is not None
                                            else torch.device("cuda", 0)]
    match_cuda._scratch(counters.device, 2 * counters.numel(), 2 * colcode.numel())
    filler = [torch.full((1 << 20,), 7, dtype=torch.int32, device=dev) for _ in range(64)]
    want = hamming.match_reduce_plain(**case, radius_px=20.0)
    for _ in range(3):
        got = prog(case)
        for name, g, w in zip(("best", "second", "idx_b", "col_idx"), got, want):
            assert torch.equal(g, w.to(g.dtype)), name
    del filler


@pytest.mark.parametrize("n,m,guided,radius", [(2048, 2048, False, 0.0),
                                               (2048, 8192, True, 8.0),
                                               (2048, 8192, True, 32.0),
                                               (2048, 8192, True, 64.0)],
                         ids=["keyframe unguided", "second pass r=8", "keyframe guided r=32",
                              "relocalization r=64"])
def test_match_kernel_equal_at_main_path_shapes(dev, n, m, guided, radius):
    """Keyframe insertion matches 2048 features to a keyframe's 2048
    without a gate, and re-observes the map guided at r=32; the tracked
    frame's second pass gates at r=8, a relocalization at r=64 (r=20 and
    the unguided global match are cases of ``test_match_kernel_equal``)."""
    case = _match_case(n * 3 + m, n, m, guided, dev)
    got = match_cuda.match_reduce(**case, radius_px=radius)
    want = hamming.match_reduce_plain(**case, radius_px=radius)
    for name, g, w in zip(("best", "second", "idx_b", "col_idx"), got, want):
        assert torch.equal(g, w.to(g.dtype)), name


@pytest.mark.parametrize("batch", [1, 3, 5])
@pytest.mark.parametrize("n,m", [(2048, 8192), (130, 70), (7, 333)])
@pytest.mark.parametrize("guided", [False, True])
def test_match_kernel_batched_equal(dev, batch, n, m, guided):
    """B sequences in one launch (the grid's z), each with its own rows,
    columns and gate: every sequence exact against the plain version; M is
    padded to a multiple of 16 with invalid columns when B > 1."""
    cases = [_match_case(n + m + 17 * b, n, m, guided, dev) for b in range(batch)]
    stacked = {k: torch.stack([c[k] for c in cases]) for k in cases[0]}
    before = match_cuda.LAUNCHES
    got = match_cuda.match_reduce(**stacked, radius_px=20.0)
    assert match_cuda.LAUNCHES == before + 1
    want = hamming.match_reduce_plain(**stacked, radius_px=20.0)
    for name, g, w in zip(("best", "second", "idx_b", "col_idx"), got, want):
        assert g.shape[0] == batch and torch.equal(g, w.to(g.dtype)), name
    for b, case in enumerate(cases[:2]):            # the same as its own launch
        for g, one in zip(got, match_cuda.match_reduce(**case, radius_px=20.0)):
            assert torch.equal(g[b], one)


def test_track_chunk_batch_card_matches_cpu(dev):
    """The multi-sequence set-up of ``tests/test_torch_multiseq.py`` (the
    port's features seed it here) tracked as one batch on the card and on
    the CPU: equal tracking and keyframe flags and feature counts, matches
    and inliers within 2%; K1 once a step."""
    from tinyslam_tpu_torch.models.vo_device import track_chunk_batch

    tcfg = P.torch_config(keyframes=True)
    frames, poses, room = P.orbit(max(P.MULTI_STARTS) + P.MULTI_FRAMES + 1)

    def features_of(frame):
        f = extract_features(torch.from_numpy(frame), tcfg.frontend.threshold, tcfg.frontend)
        return f.to_numpy()

    seeds, images, active = P.multi_sequences(frames, poses, room, features_of, tcfg)
    cam = PinholeCamera.create(**P.CAMERA)
    B = len(seeds)
    _, cpu = track_chunk_batch(cam, tcfg, VOState.stack([VOState.from_numpy(s) for s in seeds]),
                               torch.from_numpy(images), active, [Sampler(b) for b in range(B)])
    before = fast_cuda.LAUNCHES
    _, gpu = track_chunk_batch(cam, tcfg, VOState.stack([VOState.from_numpy(s, dev)
                                                         for s in seeds]),
                               torch.from_numpy(images).to(dev), active,
                               [Sampler(b) for b in range(B)])
    assert fast_cuda.LAUNCHES == before + images.shape[1]
    sg, sc = gpu["summary"].cpu().numpy(), cpu["summary"].numpy()
    np.testing.assert_array_equal(sg[..., [0, 3, 4]], sc[..., [0, 3, 4]])
    np.testing.assert_allclose(sg[..., 1:3], sc[..., 1:3], rtol=0.02)
    assert sc[..., 3][active].all()


def _pair_mask(seed, lead, n, m, dev):
    """A random ([B,] N, M) pair mask, about a third of the pairs set, with
    a row and a column of each sequence wholly clear."""
    rng = np.random.default_rng(seed)
    mask = rng.random((*lead, n, m)) < 0.35
    mask[..., n // 2, :] = False
    mask[..., :, m // 3] = False
    return torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("batch,n,m", [(0, 2048, 8192), (0, 2048, 2048), (4, 2048, 8192),
                                       (0, 100, 333), (0, 7, 1), (0, 1, 50), (0, 300, 5000),
                                       (0, 130, 70), (0, 2047, 8191), (3, 130, 70)])
def test_explicit_pair_mask_equal_on_cuda(dev, batch, n, m):
    """An explicit pair mask runs in the kernel (packed to bits on the
    card, one matcher launch), exact against the plain version; with a
    leading B (batch > 0) each sequence has its own mask."""
    lead = (batch,) if batch else ()
    cases = [_match_case(n + 5 * m + 3 * b, n, m, False, dev) for b in range(max(batch, 1))]
    case = {k: torch.stack([c[k] for c in cases]) for k in cases[0]} if batch else cases[0]
    mask = _pair_mask(n * m + batch, lead, n, m, dev)
    before = match_cuda.LAUNCHES
    got = match_cuda.match_reduce(**case, pair_mask=mask)
    assert match_cuda.LAUNCHES == before + 1
    want = hamming.match_reduce_plain(**case, pair_mask=mask)
    for name, g, w in zip(("best", "second", "idx_b", "col_idx"), got, want):
        assert g.shape == w.shape and torch.equal(g, w.to(g.dtype)), name


@pytest.mark.parametrize("kind", ["se3", "sim3", "coarse", "fine", "padded"])
def test_pose_graph_assembly_bit_equal(dev, kind):
    """The order-fixed assembly of the normal equations: for the same
    blocks the card's H and g equal the CPU's ``index_add_`` bit for bit,
    and 50 calls of ``normal_equations`` on the card equal each other, on a
    graph where many edges hit one node pair (float atomics would round
    them differently from run to run).  The blocks themselves come from
    batched products, which round otherwise on the card than on the CPU."""
    from tinyslam_tpu_torch.backend.pose_graph import (
        assembly_plan, normal_equations, normal_terms,
    )
    from tinyslam_tpu_torch.ops import scatter_cuda

    n, D, r, Ji, Jj, w, bi, bj = P.dense_graph_terms(kind)
    vals = normal_terms(r, Ji, Jj, w)
    plan = assembly_plan(bi.to(dev), bj.to(dev), n, D)
    want = scatter_cuda.ordered_scatter_add(assembly_plan(bi, bj, n, D), vals)
    before = scatter_cuda.LAUNCHES
    got = scatter_cuda.ordered_scatter_add(plan, vals.to(dev))
    assert scatter_cuda.LAUNCHES == before + 1 and torch.equal(got.cpu(), want)
    args = [x.to(dev) for x in (r, Ji, Jj, w)]
    runs = [normal_equations(plan, n * D, *args) for _ in range(50)]
    assert scatter_cuda.LAUNCHES == before + 51
    for H, g in runs[1:]:
        assert torch.equal(H, runs[0][0]) and torch.equal(g, runs[0][1])


@pytest.mark.parametrize("iters", [1, 20])
def test_device_loop_capture_equals_eager(dev, iters):
    """A Gauss-Newton-like loop (an assembly launch a turn) captured as one
    WHILE node: a replay equals the eager loop bit for bit, twice over
    (the carry restarts from the inputs at each replay), the loop's
    counter reads ``iters`` turns, and the program adds the assembly's
    launches of every turn to the counters."""
    from tinyslam_tpu_torch.backend.pose_graph import assembly_plan, normal_terms
    from tinyslam_tpu_torch.ops import scatter_cuda
    from tinyslam_tpu_torch.utils.cuda_graph import Program, device_loop

    n, D, r, Ji, Jj, w, bi, bj = P.dense_graph_terms("sim3")
    plan = assembly_plan(bi.to(dev), bj.to(dev), n, D)
    vals = normal_terms(r, Ji, Jj, w).to(dev)

    def solve(s):
        def step(x):
            Hg = scatter_cuda.ordered_scatter_add(plan, vals * x[:1])
            x = torch.tanh(x * 0.5 + Hg[:x.numel()] * 1e-12)     # bounded, turn by turn
            return x, x.sum()
        return device_loop(iters, step, s["x"])

    x0 = {"x": torch.linspace(0.5, 1.5, n * D, device=dev)}
    want = solve(x0)
    prog = Program(solve, x0, dev)
    assert tuple(prog.captured.base) == (0, 0, iters, 0)
    before = scatter_cuda.LAUNCHES
    for _ in range(2):
        got = prog(x0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert [int(t) for t in prog.captured.turns] == [iters]
    assert scatter_cuda.LAUNCHES == before + 2 * iters


# Segment lengths of the order-fixed scatter's cases: (slot, length).  The
# kernel stages a tile's run of 128 slots in 24 KB (6,144 float32 or 3,072
# float64 terms), or in chunks of that when the run is longer.  Slots 0-7
# put long lengths in one warp beside short ones and, with slot 40, overflow
# the stage (chunks); slots 130-136 are seven segments of 350 with three
# more long ones (33, 64, 100) and short ones in a tile that fits (the block
# gathers segments over 32 terms together); slots 300 and 301 two of 5,000
# in one tile (a chunk boundary inside a segment); the last slot the ragged
# end.
SEGMENTS = ((0, 5000), (1, 0), (2, 1), (3, 31), (4, 32), (5, 33), (6, 64), (7, 500),
            (40, 500), *((130 + k, 350) for k in range(7)), (140, 33), (150, 64), (160, 100),
            (200, 32), (300, 5000), (301, 5000), (302, 33), (699, 64))
SEG_SLOTS = 700


def _segment_case(dtype, seed=0):
    """(at (K,) int64, vals (K,) dtype) on the CPU: ``SEGMENTS`` plus 0-3
    terms at every other slot, listed in a random order, magnitudes over
    six decades."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 4, SEG_SLOTS)
    for slot, n in SEGMENTS:
        lengths[slot] = n
    at = rng.permutation(np.repeat(np.arange(SEG_SLOTS), lengths))
    vals = rng.standard_normal(at.size) * 10.0 ** rng.uniform(-3, 3, at.size)
    return torch.from_numpy(at), torch.from_numpy(vals).to(dtype)


def _scatter_on_card(dev, at, vals):
    from tinyslam_tpu_torch.ops import scatter_cuda

    plan = scatter_cuda.scatter_plan(at.to(dev), SEG_SLOTS)
    return plan, scatter_cuda.ordered_scatter_add(plan, vals.to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ordered_scatter_segment_lengths(dev, dtype):
    """The assembly kernel at segment lengths 0, 1, 31, 32, 33, 64, 100,
    350, 500 and 5,000, long ones in a warp with short ones, tiles whose
    terms fit the stage and tiles that overflow it: bit-equal to
    ``index_add_`` on the CPU, and 50 calls bit-equal to each other.  The
    case can see an order change: the same terms added in the reverse order
    differ in the long slots of either kind of tile."""
    from tinyslam_tpu_torch.ops import scatter_cuda

    at, vals = _segment_case(dtype)
    want = torch.zeros(SEG_SLOTS, dtype=dtype).index_add_(0, at, vals)
    reverse = torch.zeros(SEG_SLOTS, dtype=dtype).index_add_(0, at.flip(0), vals.flip(0))
    for slots in ([0, 7, 300, 301], [130, 131, 132, 133, 134, 135, 136]):
        assert not torch.equal(reverse[slots], want[slots])
    plan, got = _scatter_on_card(dev, at, vals)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)
    assert torch.equal(torch.signbit(got.cpu()), torch.signbit(want))
    before = scatter_cuda.LAUNCHES
    runs = [scatter_cuda.ordered_scatter_add(plan, vals.to(dev)) for _ in range(50)]
    assert scatter_cuda.LAUNCHES == before + 50
    assert all(torch.equal(x, got) for x in runs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ordered_scatter_special_values(dev, dtype):
    """-0.0 terms are added (a slot of -0.0 terms only sums to +0.0, as
    +0.0 + -0.0 does), inf and NaN propagate, also in long segments made of
    zeros of either sign but for one term: the finite slots bit-equal to
    ``index_add_`` on the CPU, sign of zero included; the others equal with
    NaN taken as equal to NaN (the card's NaN payload may differ)."""
    at, vals = _segment_case(dtype, seed=1)
    vals[at == 1] = -0.0                         # slot 1 of SEGMENTS holds none
    extra = {1: [-0.0] * 40, 2: [float("inf")], 3: [float("nan")]}
    # Tile 1 (its terms fit the stage): slot 160's 100 terms all zeros of
    # either sign; 131's zeros but one -5.0; 133's zeros but one NaN; 135's
    # zeros but one inf.
    signs = np.random.default_rng(2).integers(0, 2, vals.numel()).astype(bool)
    zeros = torch.where(torch.from_numpy(signs), -0.0, 0.0).to(dtype)
    for slot in (160, 131, 133, 135):
        vals[at == slot] = zeros[at == slot]
    vals[(at == 131).nonzero()[200, 0]] = -5.0
    vals[(at == 133).nonzero()[70, 0]] = float("nan")
    vals[(at == 135).nonzero()[333, 0]] = float("inf")
    long0 = (at == 0).nonzero()[:, 0]
    vals[long0[[10, 20]]] = -0.0
    vals[long0[100]] = float("inf")
    vals[long0[200]] = -float("inf")             # slot 0: inf - inf = NaN
    vals[(at == 7).nonzero()[150, 0]] = float("inf")
    vals[(at == 300).nonzero()[4500, 0]] = float("nan")
    at = torch.cat([at, torch.tensor([k for k, v in extra.items() for _ in v])])
    vals = torch.cat([vals, torch.tensor([x for v in extra.values() for x in v], dtype=dtype)])
    want = torch.zeros(SEG_SLOTS, dtype=dtype).index_add_(0, at, vals)
    assert want[1] == 0 and not torch.signbit(want[1])
    assert want[160] == 0 and not torch.signbit(want[160]) and want[131] == -5.0
    assert torch.isnan(want[[0, 3, 300, 133]]).all() and torch.isinf(want[[2, 7, 135]]).all()
    got = _scatter_on_card(dev, at, vals)[1].cpu()
    fin = torch.isfinite(want)
    assert torch.equal(got[fin], want[fin])
    assert torch.equal(torch.signbit(got[fin]), torch.signbit(want[fin]))
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("keyframes", [False, True])
def test_small_slice_card_matches_cpu(dev, keyframes):
    """The slice on the card (kernels) and on the CPU (plain versions):
    equal features, tracking and keyframe flags and landmark counts,
    matches and inliers within 2%.  With keyframes, frame 3 inserts one."""
    tcfg = P.torch_config(keyframes)
    frames, poses, room = P.orbit(5)
    feats = extract_features(torch.from_numpy(frames[0]), 0.06, tcfg.frontend)
    xy = feats.xy[feats.valid].numpy().astype(np.float64)
    X = torch.from_numpy(room.raycast(PinholeCamera.create(**P.CAMERA), *poses[0], xy)
                         .astype(np.float32))
    seed = VOState.seeded(tcfg, feats, X, *(torch.from_numpy(a) for a in poses[0]))
    images = torch.from_numpy(np.stack(frames[1:]))
    cam = PinholeCamera.create(**P.CAMERA)
    _, cpu = track_chunk(cam, tcfg, seed, images, [True] * 4, Sampler(0))
    _, gpu = track_chunk(cam, tcfg, VOState.from_numpy(seed.to_numpy(), dev),
                         images.to(dev), [True] * 4, Sampler(0))
    sg, sc = gpu["summary"].cpu().numpy(), cpu["summary"].numpy()
    np.testing.assert_array_equal(sg[:, [0, 3, 4, 5]], sc[:, [0, 3, 4, 5]])
    np.testing.assert_allclose(sg[:, 1:3], sc[:, 1:3], rtol=0.02)
    np.testing.assert_allclose(gpu["t"].cpu().numpy(), cpu["t"].numpy(), atol=1e-4)
    assert sc[:, 4].sum() == int(keyframes)


def _mid_setup(n_frames: int):
    """(cfg, cam, frames, poses, room) at 320x240, 3 levels of 256 features
    and 2,048 map points, on the orbit of ``torch_parity``.  At its 160x120
    (about 100 two-view matches) an attempt often hangs on one inlier at
    the parallax or inlier gates, and the card and the CPU part on some
    draws there (ROADMAP queue 3); here they agree on every draw measured."""
    from tinyslam_tpu_torch import config as tc
    from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory

    width, height = 320, 240
    cam = PinholeCamera.create(fx=260.0, fy=260.0, cx=159.5, cy=119.5)
    cfg = tc.SlamConfig(frontend=tc.FrontendConfig(height=height, width=width, num_levels=3,
                                                   features_per_level=256),
                        vo=tc.VOConfig(max_map_points=2048))
    room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
    poses = orbit_trajectory(n_frames, radius=2.0, step=0.02, start=-0.35,
                             target=(0.0, 0.0, 2.0))
    return cfg, cam, [room.render(cam, R, t, width, height) for R, t in poses], poses, room


@pytest.mark.parametrize("seed", range(8))
def test_small_bootstrap_and_relocalization_card_matches_cpu(dev, seed):
    """DeviceVO from frame 0 on the card and on the CPU with the same
    draws: the bootstrap on the same frame, then a relocalization forced
    after a flush; the same tracking and keyframe flags, translations
    within 1e-4, and K1 (once a frame) and K2 launched in the card's host
    phase.  Eight
    sampler seeds, so that the agreement does not rest on one set of
    draws."""
    cfg, cam, frames, _, _ = _mid_setup(16)

    def run(device):
        vo = DeviceVO(cfg, cam, chunk=4, device=device, sampler=Sampler(seed))
        for i, f in enumerate(frames):
            if i == 12:
                vo.flush()
                vo.force_reloc = True
            vo.process(f)
        vo.flush()
        return vo

    k1, k2 = fast_cuda.LAUNCHES, match_cuda.LAUNCHES
    gpu = run(dev)
    assert fast_cuda.LAUNCHES - k1 == len(frames)            # one launch a frame
    assert match_cuda.LAUNCHES - k2 >= len(frames) - gpu.host_frames + 1
    cpu = run("cpu")
    assert gpu.initialized and gpu.host_frames == cpu.host_frames <= 12
    flags = lambda vo: [(s.tracking, s.is_keyframe) for s in vo.stats]  # noqa: E731
    assert flags(gpu) == flags(cpu)
    assert all(s.tracking for s in gpu.stats[gpu.host_frames - 1:])
    np.testing.assert_allclose(np.stack([t for _, t in gpu.trajectory]),
                               np.stack([t for _, t in cpu.trajectory]), atol=1e-4)


def test_assigned_card_state_reboots_on_the_card(dev):
    """A state assigned by hand on the card, then blank frames until
    ``reloc_max_frames`` are lost: the reboot bootstraps the next submap
    on the card (K1 once on every host-phase frame, K2 in every attempt) and
    tracking goes on there."""
    base, cam, frames, poses, room = _mid_setup(16)
    cfg = dataclasses.replace(base, vo=dataclasses.replace(base.vo, reloc_max_frames=2))
    feats = extract_features(torch.from_numpy(frames[0]), 0.06, cfg.frontend)
    xy = feats.xy[feats.valid].numpy().astype(np.float64)
    X = torch.from_numpy(room.raycast(cam, *poses[0], xy).astype(np.float32))
    seed = VOState.seeded(cfg, feats, X, *(torch.from_numpy(a) for a in poses[0]))
    vo = DeviceVO(cfg, cam, chunk=4, device=dev, sampler=Sampler(0))
    vo.state = VOState.from_numpy(seed.to_numpy(), dev)
    for f in frames[1:5] + [np.zeros_like(frames[0])] * 4:
        vo.process(f)
    assert vo.num_reboots == 1 and not vo.initialized
    # The orbit again from its start, which bootstraps.
    k1, k2, host0 = fast_cuda.LAUNCHES, match_cuda.LAUNCHES, vo.host_frames
    for f in frames:
        vo.process(f)
    vo.flush()
    n_host = vo.host_frames - host0
    assert vo.initialized and vo.state.device == vo.device and vo.device.type == "cuda"
    assert fast_cuda.LAUNCHES - k1 == len(frames)            # one launch a frame
    # One unguided match per bootstrap attempt (from the fourth frame on),
    # at least one per tracked frame after it.
    assert match_cuda.LAUNCHES - k2 >= (n_host - 3) + (len(frames) - n_host)
    assert all(s.tracking for s in vo.stats[len(vo.stats) - len(frames) + n_host - 1:])


def test_device_slam_card_matches_cpu(dev):
    """``DeviceSlam`` over the out-and-back of the 160x120 orbit (frames
    0-21, then 20-0; ``loop_min_gap`` 3, as tests/test_torch_slam_device.py
    runs it against the JAX package) on the card and on the CPU with the
    same draws: the same keyframes, edges (scales within 1e-3) and loop
    decisions, at least one accepted closure, the Sim(3)-aligned ATE of the
    corrected trajectories within 1e-3 of each other, and K1 once a frame
    on the card.  (At this size a frame's pose rests on ~100 inliers, and
    one inlier that card and CPU round across the threshold moves it by
    about a centimetre, so single centres are not held to 2e-3.)"""
    from tinyslam_tpu_torch.models.slam import DeviceSlam
    from tinyslam_tpu_torch.utils.evaluation import ate_rmse

    tcfg = P.torch_config(keyframes=True)
    tcfg = dataclasses.replace(tcfg, pose_graph=dataclasses.replace(tcfg.pose_graph,
                                                                    loop_min_gap=3))
    cam = PinholeCamera.create(**P.CAMERA)
    frames, poses, _ = P.orbit(22)
    frames, poses = frames + frames[-2::-1], poses + poses[-2::-1]

    def run(device):
        slam = DeviceSlam(tcfg, cam, chunk=4, device=device, sampler=Sampler(0))
        slam.run(frames)
        return slam

    k1 = fast_cuda.LAUNCHES
    gpu = run(dev)
    assert fast_cuda.LAUNCHES - k1 == len(frames)
    cpu = run("cpu")
    assert gpu.kf_frame_of == cpu.kf_frame_of
    assert [e[:2] for e in gpu.edges] == [e[:2] for e in cpu.edges]
    np.testing.assert_allclose([e[4] for e in gpu.edges], [e[4] for e in cpu.edges],
                               rtol=0, atol=1e-3)
    keys = ("kf", "old", "n_appear", "accepted")
    assert [tuple(r[k] for k in keys) for r in gpu.loop_log] == \
        [tuple(r[k] for k in keys) for r in cpu.loop_log]
    assert gpu.num_loop_closures == cpu.num_loop_closures >= 1
    gt = np.stack([-R.T @ t for R, t in poses])
    b0 = gpu.vo.host_frames - 1
    assert b0 == cpu.vo.host_frames - 1
    dc = np.linalg.norm(gpu.positions - cpu.positions, axis=1)
    assert ate_rmse(gpu.positions[b0:], gt[b0:]) == pytest.approx(
        ate_rmse(cpu.positions[b0:], gt[b0:]), abs=1e-3), dc.round(4).tolist()


def test_slam_stage_replays_equal_their_eager_runs(dev, monkeypatch):
    """The SLAM layer's ingests, probes and solves on the card, each one
    replay of its captured program and one readback, over the run of
    ``test_device_slam_card_matches_cpu``: every output equal bit for bit
    to the eager function's on the same inputs; no sync in a load and
    replay, one (the readback) in a stage call; the launch counters
    advanced by the program's launches (K2 once an ingest, 1 + C a probe,
    the assembly once an iteration of a solve)."""
    from tinyslam_tpu_torch.bench import _with_sync_count
    from tinyslam_tpu_torch.models import slam as sm
    from tinyslam_tpu_torch.ops import scatter_cuda

    tcfg = P.torch_config(keyframes=True)
    tcfg = dataclasses.replace(tcfg, pose_graph=dataclasses.replace(tcfg.pose_graph,
                                                                    loop_min_gap=3))
    cam = PinholeCamera.create(**P.CAMERA)
    frames, _, _ = P.orbit(22)
    frames = frames + frames[-2::-1]
    calls = {k: [] for k in ("kf_ingest", "loop_probe", "solve_graph")}
    real = {k: getattr(sm, k) for k in calls}

    def counted(name):
        def wrapper(*args):
            k = (match_cuda.LAUNCHES, scatter_cuda.LAUNCHES)
            out = real[name](*args)
            calls[name].append((args, out, match_cuda.LAUNCHES - k[0],
                                scatter_cuda.LAUNCHES - k[1]))
            return out
        return wrapper

    for k in calls:
        monkeypatch.setattr(sm, k, counted(k))
    slam = sm.DeviceSlam(tcfg, cam, chunk=4, device=dev, sampler=Sampler(0))
    slam.run(frames)
    C = max(2, tcfg.pose_graph.loop_candidates)
    assert slam.num_loop_closures >= 1 and all(len(v) for v in calls.values())
    assert {(a, b) for *_, a, b in calls["kf_ingest"]} == {(1, 0)}
    assert {(a, b) for *_, a, b in calls["loop_probe"]} == {(1 + C, 0)}
    assert {(a, b) for *_, a, b in calls["solve_graph"]} == {(0, tcfg.pose_graph.gn_iters)}
    for name, runs in calls.items():
        for args, out, *_ in runs:
            assert np.array_equal(out, real[name](*args, eager=True), equal_nan=True), name
    for name, (args, *_) in ((k, v[0]) for k, v in calls.items()):
        torch.cuda.synchronize()
        assert _with_sync_count(lambda: real[name](*args))[1] == 1, name


@pytest.mark.parametrize("kind", ["rgb_uint8", "rgb_float", "gray"])
def test_gray_pyramid_blur_card_equals_cpu(dev, kind):
    """Grayscale, the 2x2 pyramid and the separable blur at 160x120 give
    the same bits on the card as on the CPU (a uint8 frame was divided by
    255 as a multiply by the reciprocal on the card)."""
    from tinyslam_tpu_torch.ops.image import build_pyramid, gaussian_blur, rgb_to_gray

    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (P.HEIGHT, P.WIDTH, 3), np.uint8)
    if kind != "rgb_uint8":
        img = img.astype(np.float32) / np.float32(255)
    if kind == "gray":
        img = img[..., 0].copy()
    x = torch.from_numpy(img)
    gray_gpu = rgb_to_gray(x.to(dev)) if kind != "gray" else x.to(dev)
    gray_cpu = rgb_to_gray(x) if kind != "gray" else x
    assert torch.equal(gray_gpu.cpu(), gray_cpu)
    for a, b in zip(build_pyramid(gray_gpu, 3), build_pyramid(gray_cpu, 3)):
        assert torch.equal(a.cpu(), b)
        assert torch.equal(gaussian_blur(a).cpu(), gaussian_blur(b))


def test_bench_rounds_repeat_on_the_card(dev):
    """``tinyslam_tpu_torch.bench``'s tracked row at full width on the
    rendered orbit, two rounds of one chunk of 8, through the graph and on
    the eager path: both rounds' summaries bit-equal (the same state, the
    same draws), every timed frame tracked, K1 once a timed frame and K2 at
    least once; the busy share in (0, 1] on the eager path and not measured
    (None) through the graph, the profiled device time a frame positive."""
    from tinyslam_tpu_torch import bench

    for graph_path in (True, False):
        got = bench.bench_tracked(chunk=8, chunks_timed=1, rounds=2, device=dev,
                                  graph_path=graph_path)
        first, second = got["round_summaries"]
        assert first.tobytes() == second.tobytes()
        assert got["boot_frame"] < bench.BOOT_FRAMES
        assert got["frames_timed"] == 16 and got["tracked_frac"] == 1.0
        assert got["per_frame"]["k1_per_frame"] == 1.0
        assert got["per_frame"]["k2_per_frame"] >= 1.0
        assert got["per_frame"]["device_ms_per_frame"] > 0.0
        if graph_path:
            assert got["per_frame"]["busy_share"] is None
        else:
            assert 0.0 < got["per_frame"]["busy_share"] <= 1.0


def _seeded_mid(cfg, frames, poses, room, cam):
    feats = extract_features(torch.from_numpy(frames[0]), 0.06, cfg.frontend)
    xy = feats.xy[feats.valid].numpy().astype(np.float64)
    X = torch.from_numpy(room.raycast(cam, *poses[0], xy).astype(np.float32))
    return VOState.seeded(cfg, feats, X, *(torch.from_numpy(a) for a in poses[0]))


def _graph_case(second_pass_below: int):
    """``_mid_setup``'s 320x240 orbit with a keyframe at least every 4
    frames (the first two into a window too small for BA, the third with
    it) and the second pass never (0) or wherever 15 or more inliers seat
    (1,000,000)."""
    base, cam, frames, poses, room = _mid_setup(33)
    cfg = dataclasses.replace(base, vo=dataclasses.replace(
        base.vo, keyframe_max_interval=4, second_pass_below=second_pass_below))
    return cfg, cam, frames, _seeded_mid(cfg, frames, poses, room, cam)


def _graph_run(cfg, cam, frames, seed, dev, graph: bool):
    """DeviceVO from the seed over frames 1-16, a relocalization forced
    after a flush (guided: the stale pose is close), frames 17-24, then a
    state whose pose is turned 0.6 rad about the vertical and marked lost
    (the guided attempt fails, the global fallback runs), frames 25-32."""
    from tinyslam_tpu_torch.geometry.se3 import so3_exp

    vo = DeviceVO(cfg, cam, chunk=4, device=dev, sampler=Sampler(0), graph=graph)
    vo.state = VOState.from_numpy(seed.to_numpy(), dev)
    k = (fast_cuda.LAUNCHES, match_cuda.LAUNCHES)
    for i in range(1, 33):
        if i == 17:
            vo.flush()
            vo.force_reloc = True
        if i == 25:
            vo.flush()
            dR = so3_exp(torch.tensor([0.0, 0.6, 0.0], device=dev))
            vo.state = vo.state.replace(R=dR @ vo.state.R, t=dR @ vo.state.t,
                                        last_tracking=torch.zeros((), dtype=torch.bool,
                                                                  device=dev))
        vo.process(frames[i])
    vo.flush()
    return vo, (fast_cuda.LAUNCHES - k[0], match_cuda.LAUNCHES - k[1])


@pytest.mark.parametrize("second_pass_below", [0, 1_000_000], ids=["one pass", "two passes"])
def test_graph_replays_equal_the_eager_path_on_every_branch(dev, second_pass_below):
    """``DeviceVO``'s captured graph against its plain ``track_chunk`` on
    the card over frames that take every branch: tracked frames, a guided
    and a global relocalization, keyframes without and with the window BA,
    and the second pass or none.  Poses, summaries and the final state bit
    for bit; the branch tally as the frames took them; the kernels' launch
    counters equal."""
    from tinyslam_tpu_torch.models.vo_device import BRANCHES, chunk_graph

    cfg, cam, frames, seed = _graph_case(second_pass_below)
    eager, eager_k = _graph_run(cfg, cam, frames, seed, dev, graph=False)
    graph = chunk_graph(cam, cfg, VOState.from_numpy(seed.to_numpy(), dev),
                        torch.from_numpy(frames[1]).to(dev), Sampler(0))
    before = graph.tally.tolist()
    replays = graph.replays
    got, got_k = _graph_run(cfg, cam, frames, seed, dev, graph=True)
    runs = dict(zip(BRANCHES, (a - b for a, b in zip(graph.tally.tolist(), before))))
    assert graph.replays - replays == 32
    assert [dataclasses.astuple(s) for s in got.stats] == \
        [dataclasses.astuple(s) for s in eager.stats]
    for (Rg, tg), (Re, te) in zip(got.trajectory, eager.trajectory):
        assert np.array_equal(Rg, Re) and np.array_equal(tg, te)
    a, b = got.state.to_numpy(), eager.state.to_numpy()
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []
    assert got_k == eager_k
    kf = sum(s.is_keyframe for s in eager.stats)
    assert runs["track"] + runs["reloc"] == 32 and runs["reloc"] >= 2
    assert runs["reloc_global"] >= 1
    assert runs["keyframe"] == kf and 1 <= runs["ba"] <= kf - 2
    assert (runs["second_pass"] > 0) == (second_pass_below > 0)
    assert all(s.tracking for s in eager.stats[:24])


def test_graph_chunk_replays_do_not_synchronize(dev):
    """A chunk through the captured graph under PyTorch's sync debug mode
    "error": every replay, image copy and result copy, and the state's load
    and copy, with no synchronizing call."""
    from tinyslam_tpu_torch.models.vo_device import chunk_graph

    cfg, cam, frames, seed = _graph_case(150)
    state = VOState.from_numpy(seed.to_numpy(), dev)
    images = torch.from_numpy(np.stack(frames[1:9])).to(dev)
    graph = chunk_graph(cam, cfg, state, images[0], Sampler(0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, ys = graph.track_chunk(state, images[:4], [True] * 4)
        state, ys = graph.track_chunk(state, images[4:], [True, True, False, False])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    summary = ys["summary"].cpu().numpy()
    assert summary[:2, 3].all() and not summary[2:].any()


def test_failed_capture_raises(dev):
    """A step that reads the device back cannot be captured: ``DeviceVO``
    raises where it would capture and never goes on eagerly; the card works
    afterwards, and the launch counters are as they were."""
    cfg, cam, frames, seed = _graph_case(150)

    class HostKeySampler(Sampler):
        def uniform(self, shape, device, key=None):
            if key is not None and key[0] == "reloc":
                key = (key[0], int(key[1]))          # a read of the frame number
            return super().uniform(shape, device, key)

    vo = DeviceVO(cfg, cam, chunk=4, device=dev, sampler=HostKeySampler(0))
    vo.state = VOState.from_numpy(seed.to_numpy(), dev)
    k = (fast_cuda.LAUNCHES, match_cuda.LAUNCHES)
    with pytest.raises(RuntimeError):
        for f in frames[1:5]:
            vo.process(f)
    assert (fast_cuda.LAUNCHES, match_cuda.LAUNCHES) == k
    assert vo.stats == [] and int(vo.state.frame_idx) == int(seed.frame_idx)
    assert float(torch.ones(3, device=dev).sum()) == 3.0


# ---------------- the batched tracker's captured step ----------------
BATCH_FRAMES = 12


def _batch_case(B: int, dev):
    """(cfg, cam, states, images (B, C, H, W) on ``dev``, active (B, C)) on
    ``_graph_case``'s orbit with the second pass wherever 15 or more inliers
    seat: row 0 from a stale pose 0.6 rad off (the global fallback), row 1
    0.02 rad off (the guided attempt), the others tracked; every row from
    the seed at frame 0 with ``frames_since_kf`` 3, so that keyframes come
    at once and the window BA by the third; row b's frames from 1 + b; the
    last row's last 3 frames of 4 rows inactive (stale and padded rows)."""
    from tinyslam_tpu_torch.geometry.se3 import so3_exp

    cfg, cam, frames, seed = _graph_case(1_000_000)
    rows = []
    for b in range(B):
        s = VOState.from_numpy(seed.to_numpy(), dev)
        s = s.replace(frames_since_kf=torch.full_like(s.frames_since_kf, 3))
        if b < 2:
            dR = so3_exp(torch.tensor([0.0, (0.6, 0.02)[b], 0.0], device=dev))
            s = s.replace(R=dR @ s.R, t=dR @ s.t, last_tracking=torch.zeros_like(s.last_tracking))
        rows.append(s)
    images = torch.from_numpy(np.stack([np.stack(frames[1 + b:1 + b + BATCH_FRAMES])
                                        for b in range(B)])).to(dev)
    active = np.ones((B, BATCH_FRAMES), bool)
    if B >= 4:
        active[-1, -3:] = False
    return cfg, cam, VOState.stack(rows), images, active


def _batch_runs(cfg, cam, states, images, active, seeds, dev):
    """The plain batched chunk and the captured one on the card from the
    same states and seeds: (eager, graph) as (state numpy, outputs numpy,
    (K1, K2) launches), the graph's branch runs and the graph."""
    from tinyslam_tpu_torch.models.vo_device import batch_graph, track_chunk_batch

    def run(graph):
        k = (fast_cuda.LAUNCHES, match_cuda.LAUNCHES)
        st, ys = track_chunk_batch(cam, cfg, states, images, active,
                                   [Sampler(s) for s in seeds], graph=graph)
        if graph:
            g.account(g.tally.tolist())
        return (st.to_numpy(), {k_: v.cpu().numpy() for k_, v in ys.items()},
                (fast_cuda.LAUNCHES - k[0], match_cuda.LAUNCHES - k[1]))

    g = batch_graph(cam, cfg, states, images[:, 0], [Sampler(s) for s in seeds])
    g.account(g.tally.tolist())
    before = g.tally.tolist()
    eager, got = run(False), run(True)
    runs = dict(zip(("reloc", "reloc_global", "second_pass", "keyframe", "ba"),
                    (a - b for a, b in zip(g.tally.tolist(), before))))
    return eager, got, runs, g


def _assert_runs_equal(eager, got):
    assert [k for k in eager[0] if not np.array_equal(eager[0][k], got[0][k])] == []
    for k in ("R", "t", "summary"):
        assert np.array_equal(eager[1][k], got[1][k]), k
    assert eager[2] == got[2]


@pytest.mark.parametrize("B", [1, 3, 4])
def test_batch_graph_replays_equal_the_eager_step_on_every_branch(dev, B):
    """``track_chunk_batch`` through the captured ``BatchGraph`` against the
    plain batched step on the card over frames that take every branch: a
    global and a guided relocalization, the second pass, keyframes without
    and with the window BA, a padded row.  Every state tensor, pose and
    summary bit for bit; the kernels' launch counters equal; the tally's
    runs, summed over rows, as the frames took them."""
    cfg, cam, states, images, active = _batch_case(B, dev)
    eager, got, runs, graph = _batch_runs(cfg, cam, states, images, active, range(B), dev)
    _assert_runs_equal(eager, got)
    s = eager[1]["summary"]
    assert s[..., 3][active].all() and not s[~active].any()
    assert runs["keyframe"] == int(s[..., 4].sum()) and runs["ba"] >= 1
    assert runs["reloc"] == min(B, 2) and runs["reloc_global"] >= 1
    assert runs["second_pass"] >= 1
    assert graph.replays >= BATCH_FRAMES


def test_batch_graph_replays_do_not_synchronize(dev):
    """A chunk of four rows through the captured step under PyTorch's sync
    debug mode "error": the states', seeds' and flags' loads, every image
    copy, replay and result copy, with no synchronizing call."""
    from tinyslam_tpu_torch.models.vo_device import batch_graph

    cfg, cam, states, images, active = _batch_case(4, dev)
    samplers = [Sampler(b) for b in range(4)]
    graph = batch_graph(cam, cfg, states, images[:, 0], samplers)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, ys = graph.track_chunk(states, images[:, :6], active[:, :6], samplers)
        st, ys = graph.track_chunk(st, images[:, 6:], active[:, 6:], samplers)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    summary = ys["summary"].cpu().numpy()
    assert summary[..., 3][active[:, 6:]].all() and not summary[~active[:, 6:]].any()


def test_one_graph_serves_every_seed(dev):
    """Two seeds through one ``ChunkGraph`` and through one ``BatchGraph``:
    each run equals its own eager run bit for bit, the relocalizations
    draw differently under the two seeds, and no second graph is
    captured."""
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.geometry.se3 import so3_exp

    cfg, cam, frames, seed = _graph_case(150)
    dR = so3_exp(torch.tensor([0.0, 0.02, 0.0], device=dev))
    lost = VOState.from_numpy(seed.to_numpy(), dev)
    lost = lost.replace(R=dR @ lost.R, t=dR @ lost.t,
                        last_tracking=torch.zeros_like(lost.last_tracking))
    images = torch.from_numpy(np.stack(frames[1:5])).to(dev)
    vd.chunk_graph(cam, cfg, lost, images[0], Sampler(0))
    n_graphs = len(vd._GRAPHS)
    for s in (0, 2**31 + 9):
        _, want = track_chunk(cam, cfg, lost, images, [True] * 4, Sampler(s))
        graph = vd.chunk_graph(cam, cfg, lost, images[0], Sampler(s))
        _, got = graph.track_chunk(lost, images, [True] * 4)
        for k in ("R", "t", "summary"):
            assert torch.equal(got[k], want[k]), (s, k)
        assert int(graph.seed) == seed_word(Sampler(s))
    assert len(vd._GRAPHS) == n_graphs
    cfg, cam, states, images, active = _batch_case(3, dev)
    n_batch = len(vd._BATCH_GRAPHS)
    for seeds in ((0, 1, 2), (2**31 + 9, 5, 2**32 + 7)):
        eager, got, _, graph = _batch_runs(cfg, cam, states, images, active, seeds, dev)
        _assert_runs_equal(eager, got)
        assert graph.seeds.tolist() == [seed_word(Sampler(s)) for s in seeds]
    assert len(vd._BATCH_GRAPHS) <= n_batch + 1


def test_batch_graphs_of_two_sizes_stay_right_after_k2_scratch_grows(dev):
    """Captures at two batch sizes in one process, then K2's scratch
    replaced by a larger one and the memory freed taken by new tensors:
    replays at both sizes still equal their eager runs bit for bit."""
    runs = {}
    for B in (1, 4):
        cfg, cam, states, images, active = _batch_case(B, dev)
        runs[B] = (cfg, cam, states, images, active)
        _assert_runs_equal(*_batch_runs(cfg, cam, states, images, active, range(B), dev)[:2])
    counters, colcode = match_cuda._SCRATCH[dev if dev.index is not None
                                            else torch.device("cuda", 0)]
    match_cuda._scratch(counters.device, 2 * counters.numel(), 2 * colcode.numel())
    filler = [torch.full((1 << 20,), 7, dtype=torch.int32, device=dev) for _ in range(64)]
    for B, case in runs.items():
        _assert_runs_equal(*_batch_runs(*case, range(B), dev)[:2])
    assert len(filler) == 64


def _dupband_both(case, r, dev):
    """The kernel's and the plain version's (dup, z_local, n_neigh) on the
    card for a ``P.dupband_scene``; checks the launch count and that the
    overflow count grew by the rows with more neighbours than the list
    holds (and a depth that is not NaN)."""
    args = [torch.from_numpy(case[k]).to(dev) for k in P.DUPBAND_ARGS]
    counter = dupband_cuda.overflow_rows(dev)
    before, launches = int(counter), dupband_cuda.LAUNCHES
    got = dupband_cuda.dup_band(*args, r)
    assert dupband_cuda.LAUNCHES == launches + 1
    want = dupband_cuda.dup_band_plain(*args, r)
    over = int(((want[2] > dupband_cuda.list_cap()) & ~torch.isnan(want[1])).sum())
    assert int(counter) - before == over
    for name, g, w in zip(("dup", "z_local", "n_neigh"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)    # NaN bit for bit
        assert torch.equal(g, w), name
    return want, over


@pytest.mark.parametrize("seed", range(20))
def test_dupband_kernel_bit_equal_at_the_keyframe_shape(dev, seed):
    """2048 features against 8192 map slots, the keyframe's shape, with
    the main path's 48 px gate: bit-equal on 20 scenes."""
    want, _ = _dupband_both(P.dupband_scene(100 + seed, n=2048, m=8192), 48.0, dev)
    assert want[0].any() and (want[2] >= 5).any()


@pytest.mark.parametrize("n,m", [(100, 333), (1, 50), (17, 257), (2047, 8191), (300, 5000)])
@pytest.mark.parametrize("r", [48.0, 20.5, 0.0])
def test_dupband_kernel_bit_equal_at_other_shapes(dev, n, m, r):
    """Ragged row blocks and map tiles, another gate, and no gate."""
    _dupband_both(P.dupband_scene(n * 7 + m, n=n, m=m), r, dev)


@pytest.mark.parametrize("r", [48.0, 0.0])
@pytest.mark.parametrize("kind", sorted(P.DUPBAND_EDGES))
def test_dupband_kernel_edge_cases(dev, kind, r):
    """No neighbour, odd and even counts with ties, distances at 40 and 48
    px, Hamming 40 and 41, invalid and out-of-view slots, NaN depths."""
    want, _ = _dupband_both(P.dupband_edge(kind), r, dev)
    assert int(want[2][0]) == P.DUPBAND_EDGES[kind][1][2]


def test_dupband_kernel_overflow_pass(dev):
    """A cluster of 1,500 map points within 25 px: rows with more
    neighbours than the list holds take the overflow pass, bit-equal, and
    the card's count of such rows grows by their number."""
    want, over = _dupband_both(P.dupband_scene(7, n=2048, m=8192, cluster=1500), 48.0, dev)
    assert over >= 100 and int(want[2].max()) > 2 * dupband_cuda.list_cap()


def test_insert_keyframe_with_the_kernel_equals_the_plain_block(dev, monkeypatch):
    """A row of the batched case after a tracked chunk on the card: its
    keyframe insertion (two triangulations, observations, the window BA)
    gives the same map, window and state bit for bit with the kernel and
    with the plain block in its place."""
    from tinyslam_tpu_torch.models import vo as vo_module
    from tinyslam_tpu_torch.models import vo_device as vd

    cfg, cam, states, images, active = _batch_case(4, dev)
    states, _ = vd.track_chunk_batch(cam, cfg, states, images, active,
                                     [Sampler(b) for b in range(4)])
    row = vd._tree_map(torch.clone, states.row(2))
    feats = extract_features(images[2, -1], row.threshold, cfg.frontend)
    none = torch.zeros_like(feats.valid)
    before = dupband_cuda.LAUNCHES
    kernel = vd._insert_keyframe(cam, cfg, row, feats, none, none).to_numpy()
    assert dupband_cuda.LAUNCHES == before + 2
    monkeypatch.setattr(vo_module, "dup_band", dupband_cuda.dup_band_plain)
    plain = vd._insert_keyframe(cam, cfg, row, feats, none, none).to_numpy()
    assert dupband_cuda.LAUNCHES == before + 2
    assert [k for k in kernel if not np.array_equal(kernel[k], plain[k], equal_nan=
                                                    kernel[k].dtype.kind == "f")] == []
    assert kernel["map.valid"].sum() > row.map.valid.sum().item()      # it inserted


def test_batch_graph_with_the_kernel_runs_the_same_work_as_the_plain_block(dev, monkeypatch):
    """Two chunks of four rows through a captured ``BatchGraph`` with the
    kernel, then through one captured with the plain block in its place,
    from the same states and seeds: every pose, per-frame summary (tracked
    flag, inliers, keyframe flag), map and window bit for bit.  The kernel's
    graph launches it twice a keyframe body run, as its counter says; the
    plain graph never."""
    from tinyslam_tpu_torch.models import vo as vo_module
    from tinyslam_tpu_torch.models import vo_device as vd

    cfg, cam, states, images, active = _batch_case(4, dev)
    samplers = [Sampler(3_000_000_000 + b) for b in range(4)]
    half = BATCH_FRAMES // 2

    def run():
        g = vd.batch_graph(cam, cfg, states, images[:, 0], samplers)
        g.account(g.tally.tolist())
        before, st, out = dupband_cuda.LAUNCHES, states, []
        for part in (slice(0, half), slice(half, BATCH_FRAMES)):
            st, ys = g.track_chunk(st, images[:, part], active[:, part], samplers)
            out.append({k: v.cpu().numpy() for k, v in ys.items()})
        runs = g.account(g.tally.tolist())
        ys = {k: np.concatenate([o[k] for o in out], axis=1) for k in out[0]}
        return st.to_numpy(), ys, runs, dupband_cuda.LAUNCHES - before

    monkeypatch.setattr(vd, "_BATCH_GRAPHS", {})
    kernel = run()
    monkeypatch.setattr(vd, "_BATCH_GRAPHS", {})
    monkeypatch.setattr(vo_module, "dup_band", dupband_cuda.dup_band_plain)
    plain = run()
    assert [k for k in kernel[0] if not np.array_equal(kernel[0][k], plain[0][k], equal_nan=
                                                       kernel[0][k].dtype.kind == "f")] == []
    for k in ("R", "t", "summary"):
        assert np.array_equal(kernel[1][k], plain[1][k]), k
    assert kernel[2] == plain[2] and kernel[2]["keyframe"] >= 2
    assert kernel[3] == 2 * kernel[2]["keyframe"] and plain[3] == 0
