"""The per-layer metrics that read the port's span records
(``slambench/chunks.py``, ``slambench/metrics/``; the recorder is
``tinyslam_tpu_torch/utils/spans.py``): the small fleet cell's window is
the recorder's chunks 1..N after the set-up's chunk 0, and each reader
gives its number on synthetic records and nothing where chunks, their
device parts or the recorder are missing."""

from __future__ import annotations

import copy

import pytest

from slambench import chunks as window_chunks
from slambench import harness
from tinyslam_tpu_torch.utils import spans

SEED = 3000000001


# ---------------- the small fleet cell on the CPU ----------------
@pytest.fixture(scope="module")
def small_fleet():
    """The fleet cell at ``slambench/tests/small.py``'s size on the CPU: its
    set-up (one warm-up chunk), a window of 0.5 s, and the records then."""
    from slambench.tests.small import small

    spans.reset()
    w, c = small("mh01_fleet8")
    run = harness.Run(w, c, SEED, 0.5, False, "cpu")
    cell = harness.load_module("traffic", w["traffic"]).Cell(run)
    rec = cell.window(0.5)
    return cell, rec, spans.records()


def test_fleet_window_is_the_recorders_chunks_1_to_n(small_fleet):
    cell, rec, records = small_fleet
    n = rec["steps"] // cell.C
    assert n >= 1 and rec["steps"] == n * cell.C
    assert [r["seq"] for r in records] == list(range(n + 1))
    for r in records:
        assert r["kind"] == "plain" and r["steps"] == cell.C and r["device"] is None
        t = [r["host_ns"][k] for k in spans.HOST_TIMES]
        assert t == sorted(t)
    for prev, cur in zip(records, records[1:]):
        assert prev["host_ns"]["exit"] <= cur["host_ns"]["entry"]


# ---------------- the readers on synthetic records ----------------
MS = 1_000_000
B, C, N = 8, 4, 3


def _synthetic():
    """Chunks 0..N of one graph: chunk k enters at k * 200 ms, its replay i
    runs 30 ms from 5 + 40 i ms on; per chunk 10 keyframes in 48 ms, 2
    relocalizations, one second pass, K1 0.1 ms a launch, K2 0.08 ms."""
    out = []
    for k in range(N + 1):
        entry = 1_792_000_000_000_000_000 + 200 * MS * k
        replays = [[entry + (5 + 40 * i) * MS, entry + (35 + 40 * i) * MS] for i in range(C)]
        out.append({
            "seq": k, "kind": "batch", "steps": C, "replays": C,
            "host_ns": {"entry": entry, "loaded": entry + MS, "launched": entry + 160 * MS,
                        "exit": entry + 161 * MS},
            "device": {"graph": 3, "replay_ns": replays, "replays_total": C * (k + 1),
                       "tally": {"reloc": 2 * k, "reloc_global": 0, "second_pass": k,
                                 "keyframe": 10 * k, "ba": 5 * k},
                       "tally_ns": {"reloc": 0, "reloc_global": 0, "second_pass": 0,
                                    "keyframe": 48 * MS * k, "ba": 0,
                                    "k1": 100_000 * C * k, "k2.track": 80_000 * (C + 1) * k},
                       "error_ns": 3_000}})
    return out


def _rec():
    return {"chunk_card_ms": [170.0] * N, "steps": N * C, "attempted": N * C * B,
            "window_s": 0.6, "k1": {"least_ms": 0.025, "ms": 0.1},
            "k2": {"least_ms": 0.02, "ms": 0.08}}


READERS = {
    "fleet.graph_ms_per_step": 30.0,
    "fleet.keyframe_ms_per_step": 12.0,
    "fleet.keyframes_per_kframe": 312.5,
    "fleet.relocs_per_kframe": 62.5,
    "k1_step_roofline": 25.0,
    "k2_step_roofline": 25.0,
    "device.graph_idle_share": 40.0,
    "fleet.caller_ms_per_chunk": 45.0,
}


def _read(name, monkeypatch, records, rec=None):
    monkeypatch.setattr(window_chunks, "harvest", lambda: records)
    return harness.load_module("metrics", name).read(_rec() if rec is None else rec)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_window_of_synthetic_records(name, monkeypatch):
    records = _synthetic()
    # Chunks after the window (the traced run's profiled ones) change nothing.
    late = copy.deepcopy(records[-1])
    late["seq"] = N + 1
    late["device"]["tally"] = {k: 10 ** 6 for k in late["device"]["tally"]}
    got = _read(name, monkeypatch, records + [late])
    assert got == pytest.approx(READERS[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_every_window_chunk(name, monkeypatch):
    records = _synthetic()
    assert _read(name, monkeypatch, records[:2] + records[3:]) is None
    assert _read(name, monkeypatch, records[:-1]) is None
    assert _read(name, monkeypatch, records[1:]) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_a_device_part(name, monkeypatch):
    for k in (0, 2):
        records = _synthetic()
        records[k]["device"] = None
        assert _read(name, monkeypatch, records) is None
    records = _synthetic()
    records[1]["device"]["graph"] = 4          # another capture's chunk
    assert _read(name, monkeypatch, records) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_from_a_program_without_records(name, monkeypatch):
    assert _read(name, monkeypatch, None) is None
    assert _read(name, monkeypatch, []) is None
    untraced = {k: v for k, v in _rec().items() if k != "chunk_card_ms"}
    assert _read(name, monkeypatch, _synthetic(), untraced) is None


def test_harvest_reads_the_programs_records():
    spans.reset()
    spans.Chunk("plain", 2).close()
    assert [r["seq"] for r in window_chunks.harvest()] == [0]
    assert window_chunks.window({"chunk_card_ms": [1.0]}) is None     # no chunk 1
