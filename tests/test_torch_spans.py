"""The span recorder of the port's tracker (``tinyslam_tpu_torch/utils/spans.py``).

On the CPU: the chunk records (sequence numbers, capacity, host times, the
ranges mirrored into a running profiler), the map of the card's timer onto
the host's clock on a fake calibration, the parse of a chunk's device
part, and the plain batched chunk's one record a chunk with answers equal
to its steps'.  The tests marked ``cuda`` stamp captured steps on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from tinyslam_tpu_torch.utils import cuda_graph, spans

SEED = 3000000001


# ---------------- the chunk records ----------------
def test_records_keep_sequence_numbers_and_the_last_capacity_chunks():
    spans.reset()
    for _ in range(spans.CAPACITY + 5):
        rec = spans.Chunk("plain", 4)
        rec.loaded()
        rec.launched()
        rec.close()
    got = spans.records()
    assert [r["seq"] for r in got] == list(range(5, spans.CAPACITY + 5))
    for r in got[:3] + got[-3:]:
        assert r["kind"] == "plain" and r["steps"] == 4 and r["device"] is None
        t = [r["host_ns"][k] for k in spans.HOST_TIMES]
        assert t == sorted(t) and t[0] > 0
    spans.reset()
    assert spans.records() == []
    spans.Chunk("plain", 1).close()
    assert [r["seq"] for r in spans.records()] == [0]


def test_host_clock_is_linear_between_calibrations_and_offset_outside():
    g0, h0 = 5_000_000_000_000, 1_792_000_000_000_000_000
    # The card's timer runs 10 ppm fast against the host's over 10 s.
    points = [(g0 + 10_000_100_000, h0 + 10_000_000_000, 3_000), (g0, h0, 2_000)]
    to_host = spans.host_clock(points)
    assert to_host(g0) == (h0, 3_000)
    assert to_host(g0 + 5_000_050_000) == (h0 + 5_000_000_000, 3_000)
    assert to_host(g0 + 10_000_100_000 + 7) == (h0 + 10_000_000_000 + 7, 3_000)
    assert to_host(g0 - 11) == (h0 - 11, 2_000)
    assert spans.host_clock([]) is None
    one = spans.host_clock([(g0, h0, 500)])
    assert one(g0 + 123_456_789) == (h0 + 123_456_789, 500)


def _row(names, ns, count, pairs):
    S = len(names)
    row = np.zeros(spans._WIDTH, dtype=np.int64)
    row[:S] = ns
    row[S] = count
    for r, (b, e) in pairs.items():
        row[S + 1 + 2 * (r % spans.STEP_CAP):S + 3 + 2 * (r % spans.STEP_CAP)] = (b, e)
    return row


def test_parse_takes_the_chunks_replays_from_the_card_ring():
    names, sites = ("reloc", "keyframe"), ("k1",)
    slots = names + sites
    count = spans.STEP_CAP + 3          # the ring has wrapped
    pairs = {r: (1_000 * r, 1_000 * r + 400) for r in range(count - 5, count)}
    row = _row(slots, [7, 11, 13], count, pairs)
    tally = np.zeros(spans.MAX_SLOTS, dtype=np.int32)
    tally[:2] = (2, 3)
    to_host = spans.host_clock([(0, 10, 4)])
    got = spans.parse(row, tally, names, slots, 5, to_host)
    assert got["replay_ns"] == [[1_000 * r + 10, 1_000 * r + 410]
                                for r in range(count - 5, count)]
    assert got["tally"] == {"reloc": 2, "keyframe": 3}
    assert got["tally_ns"] == {"reloc": 7, "keyframe": 11, "k1": 13}
    assert got["replays_total"] == count and got["error_ns"] == 4
    assert spans.parse(row, tally, names, slots, spans.STEP_CAP + 1, to_host) is None
    assert spans.parse(row, tally, names, slots, count + 1, to_host) is None
    assert spans.parse(row, tally, names, slots, 5, None) is None


def test_device_span_and_warm_stamp_nothing_off_the_card():
    with cuda_graph.device_span("k1"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    assert cuda_graph._Warm(None).stamps is None
    assert cuda_graph._Warm("cpu", ("a", "k1")).stamps is None
    assert cuda_graph.warm(lambda: cuda_graph.device_cond(
        torch.tensor(True), lambda: torch.ones(1), lambda: torch.zeros(1),
        names=("a", None)), "cpu").tolist() == [1.0]


def test_stamps_hold_at_most_max_slots_spans():
    with pytest.raises(ValueError, match="more than"):
        spans.Stamps(tuple(f"s{i}" for i in range(spans.MAX_SLOTS + 1)), "cpu")


def test_chunk_mirrors_its_host_spans_into_a_running_profiler():
    """While ``torch.profiler`` records, a chunk's spans between its host
    times show as ranges named ``HOST_SPANS``, in order; without one, no
    range is opened."""
    from torch.profiler import ProfilerActivity, profile

    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = spans.Chunk("plain", 2)
        rec.loaded()
        torch.ones(8).sum()
        rec.launched()
        rec.close()
    got = [e for e in prof.events() if e.name in spans.HOST_SPANS]
    assert sorted(e.name for e in got) == sorted(spans.HOST_SPANS)
    starts = {e.name: e.time_range.start for e in got}
    assert [starts[n] for n in spans.HOST_SPANS] == sorted(starts.values())
    quiet = spans.Chunk("plain", 2)
    assert quiet._range is None
    quiet.close()
    assert [r["seq"] for r in spans.records()] == [0, 1]


# ---------------- the plain batched chunk on the CPU ----------------
@pytest.fixture(scope="module")
def two_streams():
    """Two streams of a 160x120 orbit through a textured room, each seeded
    at its first frame's ground truth (2 levels x 128 features, 512 map
    points), and the next 4 frames of each."""
    from tinyslam_tpu_torch import config as tc
    from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models.vo_device import VOState

    width, height, C = 160, 120, 4
    cam = PinholeCamera.create(fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    cfg = tc.SlamConfig(frontend=tc.FrontendConfig(height=height, width=width, num_levels=2,
                                                   features_per_level=128),
                        vo=tc.VOConfig(max_map_points=512))
    room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
    poses = orbit_trajectory(C + 3, radius=2.0, step=0.02, start=-0.35,
                             target=(0.0, 0.0, 2.0))
    frames = [room.render(cam, R, t, width, height) for R, t in poses]
    rows, images = [], []
    for s0 in (0, 2):
        feats = extract_features(torch.from_numpy(frames[s0]), cfg.frontend.threshold,
                                 cfg.frontend)
        xy = feats.xy[feats.valid].numpy().astype(np.float64)
        X = torch.from_numpy(room.raycast(cam, *poses[s0], xy).astype(np.float32))
        rows.append(VOState.seeded(cfg, feats, X, *(torch.from_numpy(a) for a in poses[s0])))
        images.append(np.stack(frames[s0 + 1:s0 + 1 + C]))
    return cam, cfg, VOState.stack(rows), torch.from_numpy(np.stack(images))


def test_plain_chunk_batch_keeps_one_record_and_equal_answers(two_streams):
    """``track_chunk_batch(graph=False)`` on the CPU: one host record a
    chunk, and answers bit for bit those of its steps run one by one."""
    from tinyslam_tpu_torch.models.vo_device import (
        SUMMARY_FIELDS, track_chunk_batch, track_step_batch,
    )
    from tinyslam_tpu_torch.utils.draws import Sampler

    cam, cfg, states, images = two_streams
    B, C = images.shape[:2]
    active = np.ones((B, C), dtype=bool)
    active[1, -1] = False
    spans.reset()
    spans.Chunk("plain", C).close()
    before = spans.records()
    st, ys = track_chunk_batch(cam, cfg, states, images, active,
                               [Sampler(SEED + b) for b in range(B)], graph=False)
    after = spans.records()
    assert len(after) == len(before) + 1
    new = after[-1]
    assert new["seq"] == before[-1]["seq"] + 1 and new["kind"] == "plain"
    assert new["steps"] == C and new["replays"] == 0 and new["device"] is None
    t = [new["host_ns"][k] for k in spans.HOST_TIMES]
    assert t == sorted(t) and before[-1]["host_ns"]["exit"] <= t[0]
    want, samplers, outs = states, [Sampler(SEED + b) for b in range(B)], []
    for c in range(C):
        want, y = track_step_batch(cam, cfg, want, images[:, c], active[:, c], samplers)
        outs.append(y)
    assert len(spans.records()) == len(after)
    tracking = SUMMARY_FIELDS.index("tracking")
    assert ys["summary"][0, :, tracking].all()     # tracked, so the steps did their work
    for k in ("R", "t", "summary"):
        assert torch.equal(ys[k], torch.stack([y[k] for y in outs], 1)), k
    a, b = st.to_numpy(), want.to_numpy()
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []


# ---------------- on the card ----------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda", torch.cuda.current_device())


def _branchy(dev):
    """A captured step with two named bodies on one predicate, a site and
    work outside them; returns (captured, pred buffer)."""
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    x = torch.ones(1 << 20, device=dev)

    def step():
        with cuda_graph.device_span("site"):
            y = x * 2.0
        out = cuda_graph.device_cond(pred, lambda v: (v.sin() * v.cos()).sum() + v.sum(),
                                     lambda v: v.sum(), (y,), names=("heavy", "light"))
        return out + y[:1].sum()

    with cuda_graph.CAPTURE_LOCK, cuda_graph.counters_kept():
        cuda_graph.warm_checked(step, dev, ("heavy", "light"), ("site",))
        captured = cuda_graph.capture(step, dev, ("heavy", "light"), sites=("site",))
    return captured, pred


@pytest.mark.cuda
def test_a_body_accumulates_nanoseconds_only_where_taken(dev):
    captured, pred = _branchy(dev)
    st = captured.stamps
    ns0 = st.tally_ns.tolist()
    pred.fill_(True)
    for _ in range(3):
        captured.graph.replay()
    torch.cuda.synchronize()
    ns1 = st.tally_ns.tolist()
    assert captured.tally.tolist() == [3, 0]
    assert ns1[0] > ns0[0] and ns1[1] == ns0[1] == 0 and ns1[2] > 0
    pred.fill_(False)
    captured.graph.replay()
    torch.cuda.synchronize()
    ns2 = st.tally_ns.tolist()
    assert captured.tally.tolist() == [3, 1]
    assert ns2[0] == ns1[0] and ns2[1] > 0 and ns2[2] > ns1[2]


@pytest.mark.cuda
def test_a_replays_span_holds_its_bodies_and_maps_between_host_readings(dev):
    captured, pred = _branchy(dev)
    pred.fill_(True)
    spans.reset()
    before = time.time_ns()
    rec = spans.Chunk("batch", 2)
    rec.loaded()
    tally_ns = []
    for _ in range(2):
        captured.graph.replay()
        tally_ns.append(captured.stamps.tally_ns.clone())
    rec.launched()
    rec.close(captured, 2)
    got = spans.records()
    after = time.time_ns()
    d = got[0]["device"]
    assert d is not None and d["tally"] == {"heavy": 2, "light": 0}
    err = d["error_ns"]
    assert 0 <= err < 1_000_000
    body = (tally_ns[1] - tally_ns[0]).tolist()
    b, e = d["replay_ns"][1]
    assert e - b >= body[0] + body[2] > 0
    for b, e in d["replay_ns"]:
        assert before - err <= b <= e <= after + err
    assert got[0]["host_ns"]["loaded"] - err <= d["replay_ns"][0][0]


@pytest.mark.cuda
def test_warm_checked_runs_the_stamps_without_a_sync(dev):
    _branchy(dev)
    assert cuda_graph._Warm(dev, ("heavy", "site")).stamps is not None
    assert cuda_graph._Warm(dev).stamps is None


@pytest.mark.cuda
def test_a_capture_without_names_holds_no_stamps(dev):
    """A ``Program`` (the SLAM layer's captures) and a capture with no
    names or sites hold no stamp node and calibrate nothing."""
    spans._CALIBRATIONS.clear()
    x = torch.arange(4.0, device=dev)
    prog = cuda_graph.Program(lambda s: s * 2.0, x, dev)
    assert prog.captured.stamps is None
    assert prog(x + 1.0).tolist() == [2.0, 4.0, 6.0, 8.0]
    with cuda_graph.CAPTURE_LOCK, cuda_graph.counters_kept():
        cuda_graph.warm_checked(lambda: x + 1.0, dev)
        captured = cuda_graph.capture(lambda: x + 1.0, dev, ())
    assert captured.stamps is None
    assert spans._CALIBRATIONS == {}
    rec = spans.Chunk("chunk", 1)
    rec.close(captured, 1)
    assert rec.stamps is None and spans.records()[-1]["device"] is None
