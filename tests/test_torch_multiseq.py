"""Multi-sequence tracking: the port's ``track_chunk_batch`` (B camera
streams as one batched program) against the JAX package's
``jax.vmap(track_chunk)``, against the port's own per-sequence
``track_chunk``, and under frame parallelism (``track_chunk_dp``) over
1 and 2 gloo ranks.

The set-up (``torch_parity.multi_sequences``, keyframes on): three
sequences seeded from the JAX package's features at orbit frames 0, 3 and
6, 8 frames each; sequence 1 starts lost (its stale pose 0.6 rad off, the
global fallback re-acquires), sequence 2's last 2 frames are inactive.
Tolerances: against the JAX package ``test_torch_tracking.py``'s --
``tracking``, ``is_keyframe`` and ``num_features`` equal, matches and
inliers within 2%, camera centres within 2 mm, rotations within 1e-3 rad;
against the per-sequence port every flag and count equal (the final
state's integer fields too), R within 1e-5 and t within 5e-5 (the batch
multiplies its 3x3 poses and PnP gradients in PyTorch's batched matrix
kernel, the single sequence in its two-matrix one, which rounds
otherwise; 1.6e-5 measured); over ranks bit for bit (the batched kernel
rounds a sequence alike at any batch size).  A second set-up of four
sequences has two rows relocalize (guided and global) and two keyframe in
one step, against the JAX package and each row alone at those
tolerances, under the JAX package's draws and under the port's keyed
draws with seeds above 2**31.  ``track_step_batch`` reads nothing back
outside ``device_cond`` (every host read of a tensor made to raise), and
a step with every row inactive keeps the state bit for bit.  The batched pieces (extraction at a
threshold a frame, the matcher, PnP, the state's stack and rows) hold
against their per-sequence counterparts: bit for bit, integers exact, PnP
within 1e-6.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu.frontend.orb import extract_features as jextract
from tinyslam_tpu.models.vo_device import VOState as JVOState
from tinyslam_tpu.models.vo_device import track_chunk as jtrack_chunk
from tinyslam_tpu_torch.config import FrontendConfig
from tinyslam_tpu_torch.frontend.orb import extract_batch, extract_features
from tinyslam_tpu_torch.geometry import pnp as tpnp
from tinyslam_tpu_torch.geometry.se3 import se3_exp
from tinyslam_tpu_torch.models.vo_device import (
    SUMMARY_FIELDS, VOState, track_chunk, track_chunk_batch, track_step_batch,
)
from tinyslam_tpu_torch.ops import hamming
from tinyslam_tpu_torch.utils.cuda_graph import tree_leaves
from tinyslam_tpu_torch.utils.draws import Sampler

REPO = Path(__file__).resolve().parents[1]
_COL = {name: i for i, name in enumerate(SUMMARY_FIELDS)}
_INT_FIELDS = ("num_features", "num_matches", "num_inliers", "tracking", "is_keyframe",
               "num_landmarks")
_FRAMES, _POSES, _ROOM = P.orbit(max(P.MULTI_STARTS) + P.MULTI_FRAMES + 1)
DP_ORDER = (0, 1, 2, 0)       # the four sequences of the ranks' run
DP_WORLDS = (1, 2)

_WORKER = r"""
import sys
sys.modules["jax"] = None           # any import of jax now raises ImportError
import numpy as np, torch
torch.set_num_threads(2)
import torch.distributed as dist
from tests import torch_parity as P
from tinyslam_tpu_torch.config import MeshConfig
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models.vo_device import VOState
from tinyslam_tpu_torch.parallel import initialize_multihost, make_mesh, track_chunk_dp
from tinyslam_tpu_torch.utils.draws import Sampler

rank, world = int(sys.argv[1]), int(sys.argv[2])
port, inp, out = sys.argv[3:6]
initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
I = dict(np.load(inp))
B = I["images"].shape[0]
states = VOState.stack([VOState.from_numpy({k[len(f"s{b}."):]: v for k, v in I.items()
                                            if k.startswith(f"s{b}.")}) for b in range(B)])
mesh = make_mesh(MeshConfig(world, 1), "cpu")
st, ys = track_chunk_dp(mesh, PinholeCamera.create(**P.CAMERA), P.torch_config(keyframes=True),
                        states, torch.from_numpy(I["images"]), torch.from_numpy(I["active"]),
                        [Sampler(b) for b in range(B)])
np.savez(out, **{k: v.numpy() for k, v in ys.items()},
         **{"st." + k: v for k, v in st.to_numpy().items()})
dist.destroy_process_group()
"""


def _jax_features(frame) -> dict:
    jcfg, _ = P.configs(keyframes=True)
    f = jextract(jnp.asarray(frame), jnp.float32(jcfg.frontend.threshold), jcfg.frontend)
    return P.features_numpy(f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup():
    _, tcfg = P.configs(keyframes=True)
    seeds, images, active = P.multi_sequences(_FRAMES, _POSES, _ROOM, _jax_features, tcfg)
    return {"cfg": tcfg, "cam": P.cameras()[1], "seeds": seeds, "images": images,
            "active": active}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """The ranks' runs, started first (they run while the JAX reference
    compiles): {world: [the output of each rank]}."""
    tmp = tmp_path_factory.mktemp("multiseq")
    inp = {"images": setup["images"][list(DP_ORDER)], "active": setup["active"][list(DP_ORDER)]}
    for b, s in enumerate(DP_ORDER):
        inp.update({f"s{b}.{k}": v for k, v in setup["seeds"][s].items()})
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = {}
    for w in DP_WORLDS:
        port = str(_free_port())
        procs[w] = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(w), port, str(tmp / "in.npz"),
             str(tmp / f"out{w}_{r}.npz")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO, env=env) for r in range(w)]

    def results():
        out = {}
        for w, ps in procs.items():
            for r, p in enumerate(ps):
                log = p.communicate(timeout=600)[0]
                assert p.returncode == 0, f"world {w} rank {r}:\n{log[-3000:]}"
            out[w] = [dict(np.load(tmp / f"out{w}_{r}.npz")) for r in range(w)]
        return out

    try:
        yield inp, results
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def runs(setup, ranks):
    """The JAX reference, the batched port and the per-sequence port, all
    with the JAX package's draws."""
    jcfg, _ = P.configs(keyframes=True)
    jcam, tcam = P.cameras()
    cfg, seeds, images, active = (setup[k] for k in ("cfg", "seeds", "images", "active"))
    jstates = jax.tree.map(lambda *xs: jnp.stack(xs), *[P.jax_state(s) for s in seeds])
    assert isinstance(jstates, JVOState)
    step = jax.jit(jax.vmap(lambda s, im, a: jtrack_chunk(jcam, jcfg, s, im, a)))
    _, jys = step(jstates, jnp.asarray(images), jnp.asarray(active))
    samplers = [P.JaxSampler() for _ in seeds]
    st, ys = track_chunk_batch(tcam, cfg, VOState.stack([VOState.from_numpy(s) for s in seeds]),
                               torch.from_numpy(images), active, samplers)
    singles = []
    for b, seed in enumerate(seeds):
        sampler = P.JaxSampler()
        s1, y1 = track_chunk(tcam, cfg, VOState.from_numpy(seed), torch.from_numpy(images[b]),
                             active[b], sampler)
        singles.append((s1, {k: v.numpy() for k, v in y1.items()}, sampler.calls))
    return {"jax": {k: np.asarray(v) for k, v in jys.items()}, "state": st,
            "batch": {k: v.numpy() for k, v in ys.items()}, "calls": [s.calls for s in samplers],
            "singles": singles}


def _centres(R, t):
    return np.einsum("...ji,...j->...i", R, -t)


def test_batch_relocalizes_keyframes_and_pads(runs, setup):
    """The set-up exercises every branch: the lost sequence relocalizes on
    its first frame (drawing under its own key, guided then global),
    keyframes are inserted, and the padded frames record zero summaries."""
    s = runs["batch"]["summary"]
    assert runs["calls"][P.LOST_SEQ] == [("reloc", 9)] * 2
    assert [c for b, c in enumerate(runs["calls"]) if b != P.LOST_SEQ] == [[], []]
    assert s[..., _COL["tracking"]][setup["active"]].all()
    assert s[..., _COL["is_keyframe"]].sum() >= 3
    np.testing.assert_array_equal(s[2, -P.MULTI_INACTIVE:], 0)
    assert runs["batch"]["R"].shape == (3, P.MULTI_FRAMES, 3, 3)
    assert runs["batch"]["summary"].shape == (3, P.MULTI_FRAMES, len(SUMMARY_FIELDS))


@pytest.mark.parametrize("b", range(len(P.MULTI_STARTS)))
def test_batch_tracks_like_jax_vmap(runs, b):
    j, t = runs["jax"], runs["batch"]
    sj, st = j["summary"][b], t["summary"][b]
    for name in ("tracking", "is_keyframe", "num_features"):
        np.testing.assert_array_equal(st[:, _COL[name]], sj[:, _COL[name]], err_msg=name)
    for name in ("num_matches", "num_inliers"):
        np.testing.assert_allclose(st[:, _COL[name]], sj[:, _COL[name]], rtol=0.02, err_msg=name)
    dc = np.linalg.norm(_centres(t["R"][b], t["t"][b]) - _centres(j["R"][b], j["t"][b]), axis=-1)
    assert dc.max() < 2e-3, dc
    dR = np.einsum("nij,nik->njk", t["R"][b], j["R"][b])
    angle = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert angle.max() < 1e-3, angle


@pytest.mark.parametrize("b", range(len(P.MULTI_STARTS)))
def test_batch_equals_each_sequence_alone(runs, b):
    s1, y1, calls = runs["singles"][b]
    t = runs["batch"]
    for name in _INT_FIELDS:
        np.testing.assert_array_equal(t["summary"][b][:, _COL[name]], y1["summary"][:, _COL[name]],
                                      err_msg=name)
    np.testing.assert_allclose(t["R"][b], y1["R"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["t"][b], y1["t"], rtol=0, atol=5e-5)
    assert calls == runs["calls"][b]
    row = runs["state"].row(b).to_numpy()
    for k, v in s1.to_numpy().items():      # the map, window and ring: slots and counts
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(row[k], v, err_msg=k)


@pytest.mark.parametrize("world", DP_WORLDS)
def test_track_chunk_dp_equals_the_batch(setup, ranks, world):
    """Every rank returns the global result, bit-equal to one process
    tracking all four sequences as one batch."""
    inp, results = ranks
    B = len(DP_ORDER)
    _, tcam = P.cameras()
    st, ys = track_chunk_batch(
        tcam, setup["cfg"], VOState.stack([VOState.from_numpy(setup["seeds"][s])
                                           for s in DP_ORDER]),
        torch.from_numpy(inp["images"]), inp["active"], [Sampler(b) for b in range(B)])
    want = {**{k: v.numpy() for k, v in ys.items()},
            **{"st." + k: v for k, v in st.to_numpy().items()}}
    for out in results()[world]:
        assert out.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    assert want["summary"][:, :, _COL["tracking"]][inp["active"]].all()


@pytest.mark.parametrize("brief", ["binned", "nearest", "bilinear"])
def test_extract_batch_threshold_a_frame_equals_each_frame(brief):
    """(B,) thresholds: each frame bit-equal to ``extract_features`` at its
    own threshold; a scalar still serves the whole batch."""
    extra = {"binned": {}, "nearest": dict(brief_bins=0),
             "bilinear": dict(interpolate_descriptors=True)}[brief]
    cfg = FrontendConfig(**P.FRONTEND, **extra)
    images = torch.from_numpy(np.stack(_FRAMES[:3]))
    th = torch.tensor([0.03, 0.06, 0.12])
    batch = extract_batch(images, th, cfg)
    counts = batch.count.tolist()
    assert counts[0] > counts[2]
    for b in range(3):
        one = extract_features(images[b], th[b], cfg)
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(batch, f.name)[b], getattr(one, f.name)), (b, f.name)
    shared = extract_batch(images, 0.06, cfg)
    assert torch.equal(shared.desc[0], extract_features(images[0], 0.06, cfg).desc)
    with pytest.raises(ValueError):
        extract_batch(images, torch.tensor([0.06, 0.06]), cfg)


def _match_sets(seed: int, B: int, n: int, m: int):
    """B sets of n features, each drawn near one of its own m map points (in
    descriptor and in the image), with duplicates for the tie-breaks."""
    rng = np.random.default_rng(seed)
    T = torch.from_numpy
    desc_b = np.stack([P.rand_desc(rng, m) for _ in range(B)])
    proj_b = rng.uniform(0, 160, (B, m, 2)).astype(np.float32)
    src = rng.integers(0, m, (B, n))
    desc_a = np.stack([P.perturb(rng, d[s]) for d, s in zip(desc_b, src)])
    xy_a = np.take_along_axis(proj_b, src[..., None], 1) + rng.normal(0, 8, (B, n, 2))
    return dict(desc_a=T(desc_a.view(np.int32)), valid_a=T(rng.random((B, n)) > 0.1),
                desc_b=T(desc_b.view(np.int32)), valid_b=T(rng.random((B, m)) > 0.1),
                xy_a=T(xy_a.astype(np.float32)), proj_b=T(proj_b))


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("B,n,m", [(1, 64, 100), (3, 130, 70), (5, 7, 333)])
def test_batched_matcher_equals_each_sequence(guided, B, n, m):
    """``match_reduce_plain`` and ``match_descriptors`` over a leading B:
    every sequence's integers equal to its own call's, each with its own
    gate."""
    case = _match_sets(B * 100 + n, B, n, m)
    if not guided:
        case = {k: v for k, v in case.items() if k not in ("xy_a", "proj_b")}
    got = hamming.match_reduce_plain(**case, radius_px=20.0)
    matched = hamming.match_descriptors(**case, radius_px=20.0)
    for b in range(B):
        one = {k: v[b] for k, v in case.items()}
        for g, w in zip(got, hamming.match_reduce_plain(**one, radius_px=20.0)):
            assert torch.equal(g[b], w)
        for k, v in hamming.match_descriptors(**one, radius_px=20.0).items():
            assert torch.equal(matched[k][b], v), k
    assert int(matched["valid"].sum()) > 0


def test_batched_pnp_refine_equals_each_sequence():
    """``pnp_refine`` with a leading B on the points, pixels, masks and
    poses: each sequence within 1e-6 of its own call."""
    _, tcam = P.cameras()
    rng = np.random.default_rng(11)
    B, n = 3, 200
    X = (rng.uniform(-1, 1, (B, n, 3)) * [1.5, 1.0, 0.5] + [0, 0, 4]).astype(np.float32)
    R_true, t_true = se3_exp(torch.from_numpy(rng.normal(0, 0.05, (B, 6)).astype(np.float32)))
    pc = np.einsum("bij,bnj->bni", R_true.numpy(), X) + t_true.numpy()[:, None]
    uv = np.stack([130.0 * pc[..., 0] / pc[..., 2] + 79.5, 130.0 * pc[..., 1] / pc[..., 2] + 59.5],
                  -1).astype(np.float32) + rng.normal(0, 0.5, (B, n, 2)).astype(np.float32)
    uv[rng.random((B, n)) < 0.2] += 30.0
    valid = rng.random((B, n)) > 0.05
    R0, t0 = se3_exp(torch.zeros(B, 6))
    T = torch.from_numpy
    got = tpnp.pnp_refine(tcam, T(X), T(uv), T(valid), R0, t0)
    for b in range(B):
        one = tpnp.pnp_refine(tcam, T(X[b]), T(uv[b]), T(valid[b]), R0[b], t0[b])
        for k in ("R", "t", "rmse"):
            np.testing.assert_allclose(got[k][b].numpy(), one[k].numpy(), rtol=0, atol=1e-6)
        assert torch.equal(got["inliers"][b], one["inliers"])
        assert int(got["num_inliers"][b]) == int(one["num_inliers"])
    np.testing.assert_allclose(got["R"].numpy(), R_true.numpy(), rtol=0, atol=1e-2)


def test_state_stack_rows_round_trip(setup):
    """``VOState.stack``, ``row`` and ``unstack`` round-trip exactly,
    through the nested map, window features and keyframe ring; a write
    through a row's views lands in that row of the batch alone."""
    states = [VOState.from_numpy(s) for s in setup["seeds"]]
    batch = VOState.stack(states)
    assert batch.R.shape == (3, 3, 3) and batch.map.X.shape[0] == 3
    assert batch.kf_ring.desc.shape[:2] == (3, states[0].kf_ring.desc.shape[0])

    def equal(a: VOState, b: VOState) -> bool:
        da, db = a.to_numpy(), b.to_numpy()
        return da.keys() == db.keys() and all(np.array_equal(da[k], db[k]) for k in da)

    assert all(equal(batch.row(b), s) for b, s in enumerate(states))
    assert all(equal(x, s) for x, s in zip(batch.unstack(), states))
    for dst, src in zip(tree_leaves(batch.row(0)), tree_leaves(states[2])):
        dst.copy_(src)
    assert equal(batch.row(0), states[2]) and equal(batch.row(1), states[1])
    assert equal(batch.row(2), states[2])


# ---------------- one step: two relocalizations and two keyframes ----------------
STEP_ROWS = ((0, 0.02), (3, 0.6), (0, None), (3, None))   # (seed frame, yaw of a lost row)
STEP_FRAMES = 3
STEP_SEEDS = (0, 2**31 + 5, 7, 2**33 + 1)      # Sampler seeds, two above 2**31


@pytest.fixture(scope="module")
def four_rows():
    """Four sequences whose first step has rows 0 and 1 relocalize (0.02 rad
    off: the guided attempt; 0.6 rad: the global fallback) and rows 2 and 3
    keyframe (``frames_since_kf`` one short of the interval), then two more
    frames; the batch with the JAX package's draws against ``jax.vmap(
    track_chunk)`` and against each row's own ``track_chunk``, and the batch
    with the port's keyed draws under ``STEP_SEEDS`` against each row's
    own."""
    jcfg, tcfg = P.configs(keyframes=True)
    jcam, tcam = P.cameras()
    feats = {s0: _jax_features(_FRAMES[s0]) for s0 in {s0 for s0, _ in STEP_ROWS}}
    rows, images = [], []
    for s0, yaw in STEP_ROWS:
        seed = P.seeded_state(tcfg, feats[s0], _ROOM, _POSES[s0])
        if yaw is None:
            seed["frames_since_kf"] = np.asarray(tcfg.vo.keyframe_max_interval - 1, np.int32)
        rows.append(seed if yaw is None else P.lost_state(seed, yaw))
        first = s0 if yaw is not None else s0 + 1
        images.append(np.stack(_FRAMES[first:first + STEP_FRAMES]))
    images = np.stack(images)
    active = np.ones(images.shape[:2], bool)
    jstates = jax.tree.map(lambda *xs: jnp.stack(xs), *[P.jax_state(r) for r in rows])
    step = jax.jit(jax.vmap(lambda s, im, a: jtrack_chunk(jcam, jcfg, s, im, a)))
    _, jys = step(jstates, jnp.asarray(images), jnp.asarray(active))
    out = {"jax": {k: np.asarray(v) for k, v in jys.items()}, "rows": rows, "cfg": tcfg,
           "cam": tcam, "images": images, "active": active}
    for name, make in (("jaxdraws", lambda b: P.JaxSampler()), ("keyed", Sampler)):
        samplers = [make(STEP_SEEDS[b]) for b in range(len(rows))]
        st, ys = track_chunk_batch(tcam, tcfg, VOState.stack([VOState.from_numpy(r)
                                                              for r in rows]),
                                   torch.from_numpy(images), active, samplers)
        singles = [track_chunk(tcam, tcfg, VOState.from_numpy(r), torch.from_numpy(images[b]),
                               active[b], make(STEP_SEEDS[b])) for b, r in enumerate(rows)]
        out[name] = {"state": st, "ys": {k: v.numpy() for k, v in ys.items()},
                     "singles": [(s, {k: v.numpy() for k, v in y.items()}) for s, y in singles]}
    return out


def test_four_row_step_relocalizes_two_rows_and_keyframes_two(four_rows):
    for name in ("jaxdraws", "keyed"):
        s = four_rows[name]["ys"]["summary"][:, 0]
        assert s[:, _COL["tracking"]].all(), name
        np.testing.assert_array_equal(s[:, _COL["is_keyframe"]], [0, 0, 1, 1], err_msg=name)
        assert all(bool(r["last_tracking"]) == (b >= 2)
                   for b, r in enumerate(four_rows["rows"]))


@pytest.mark.parametrize("b", range(len(STEP_ROWS)))
def test_four_row_step_tracks_like_jax_vmap(four_rows, b):
    j, t = four_rows["jax"], four_rows["jaxdraws"]["ys"]
    sj, st = j["summary"][b], t["summary"][b]
    for name in ("tracking", "is_keyframe", "num_features"):
        np.testing.assert_array_equal(st[:, _COL[name]], sj[:, _COL[name]], err_msg=name)
    for name in ("num_matches", "num_inliers"):
        np.testing.assert_allclose(st[:, _COL[name]], sj[:, _COL[name]], rtol=0.02, err_msg=name)
    dc = np.linalg.norm(_centres(t["R"][b], t["t"][b]) - _centres(j["R"][b], j["t"][b]), axis=-1)
    assert dc.max() < 2e-3, dc
    dR = np.einsum("nij,nik->njk", t["R"][b], j["R"][b])
    angle = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert angle.max() < 1e-3, angle


@pytest.mark.parametrize("draws", ["jaxdraws", "keyed"])
@pytest.mark.parametrize("b", range(len(STEP_ROWS)))
def test_four_row_step_equals_each_row_alone(four_rows, draws, b):
    run = four_rows[draws]
    s1, y1 = run["singles"][b]
    t = run["ys"]
    for name in _INT_FIELDS:
        np.testing.assert_array_equal(t["summary"][b][:, _COL[name]], y1["summary"][:, _COL[name]],
                                      err_msg=name)
    np.testing.assert_allclose(t["R"][b], y1["R"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["t"][b], y1["t"], rtol=0, atol=5e-5)
    row = run["state"].row(b).to_numpy()
    for k, v in s1.to_numpy().items():
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(row[k], v, err_msg=k)


_HOST_READS = ("tolist", "item", "numpy", "__array__", "__bool__", "__int__", "__float__",
               "__index__")


def test_batched_step_reads_nothing_back_outside_device_cond(four_rows, monkeypatch):
    """``track_chunk_batch`` (a step a frame) and ``track_step_batch`` with
    every host read of a tensor made to raise, ``device_cond`` alone
    allowed to read its predicate: the four-row chunk (relocalizations,
    keyframes, the window BA's condition, the second pass) and a step with
    every row inactive read nothing else, and give the results of the
    unguarded run."""
    from tinyslam_tpu_torch.models import vo as tvo
    from tinyslam_tpu_torch.models import vo_device as tvd

    allowed, reads, taken = [False], [], []

    def guarded(name):
        real = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            if not allowed[0]:
                reads.append(name)
                raise RuntimeError(f"a host read ({name}) outside device_cond")
            return real(self, *a, **kw)
        return read

    def cond(pred, true_fn, false_fn, operands=(), names=(None, None)):
        allowed[0] = True
        try:
            p = bool(pred)
        finally:
            allowed[0] = False
        taken.append(names[0] if p else names[1])
        return true_fn(*operands) if p else false_fn(*operands)

    cfg, cam, images, active = (four_rows[k] for k in ("cfg", "cam", "images", "active"))
    rows = VOState.stack([VOState.from_numpy(r) for r in four_rows["rows"]])
    samplers = [Sampler(s) for s in STEP_SEEDS]
    with monkeypatch.context() as m:
        for name in _HOST_READS:
            m.setattr(torch.Tensor, name, guarded(name))
        m.setattr(tvd, "device_cond", cond)
        m.setattr(tvo, "device_cond", cond)
        st, ys = track_chunk_batch(cam, cfg, rows, torch.from_numpy(images), active, samplers)
        idle, idle_ys = tvd.track_step_batch(cam, cfg, st, torch.from_numpy(images[:, 0]),
                                             torch.zeros(len(STEP_ROWS), dtype=torch.bool),
                                             samplers)
    assert reads == []
    assert {"reloc", "reloc_global", "keyframe", "second_pass"} <= set(taken)
    for k, v in ys.items():
        np.testing.assert_array_equal(v.numpy(), four_rows["keyed"]["ys"][k], err_msg=k)
    assert not idle_ys["summary"].any()


def test_step_with_every_row_inactive_keeps_the_state(four_rows):
    """Every row inactive: the state as it was, bit for bit, zero summaries;
    in ``track_chunk_batch`` such a step (the host's flags show it) is
    skipped and gives what the step gives."""
    cfg, cam, images = (four_rows[k] for k in ("cfg", "cam", "images"))
    B = len(STEP_ROWS)
    states = VOState.stack([VOState.from_numpy(r) for r in four_rows["rows"]])
    before = states.to_numpy()
    samplers = [Sampler(s) for s in STEP_SEEDS]
    st, ys = track_step_batch(cam, cfg, states, torch.from_numpy(images[:, 0]), [False] * B,
                              samplers)
    after, kept = states.to_numpy(), st.to_numpy()
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)    # left as it was
        np.testing.assert_array_equal(kept[k], before[k], err_msg=k)
    assert not ys["summary"].any()
    assert torch.equal(ys["R"], states.R) and torch.equal(ys["t"], states.t)
    active = np.ones((B, STEP_FRAMES), bool)
    active[:, 1] = False
    st2, ys2 = track_chunk_batch(cam, cfg, states, torch.from_numpy(images), active, samplers)
    s1, y1 = track_step_batch(cam, cfg, states, torch.from_numpy(images[:, 0]), [True] * B,
                              samplers)
    s1, y2 = track_step_batch(cam, cfg, s1, torch.from_numpy(images[:, 2]), [True] * B,
                              samplers)
    assert not ys2["summary"][:, 1].any()
    assert torch.equal(ys2["R"][:, 1], y1["R"]) and torch.equal(ys2["R"][:, 2], y2["R"])
    assert torch.equal(ys2["summary"][:, 2], y2["summary"])
    final, want = st2.to_numpy(), s1.to_numpy()
    assert [k for k in want if not np.array_equal(final[k], want[k])] == []
