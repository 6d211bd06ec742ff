"""The reader of ``fleet.tri_ms_per_step`` (``slambench/metrics/``): the
``tri`` site's nanoseconds (each keyframe's two triangulations) over the
window's replays, on synthetic span records, and nothing from a program
whose captured step has no such site or keeps no records."""

from __future__ import annotations

import pytest

from slambench import chunks as window_chunks
from slambench import harness

MS = 1_000_000
C, N = 4, 3                 # steps a chunk, window chunks


def _records(sites=("tri",)):
    """Chunks 0..N of one graph, C replays each; per chunk 10 keyframe
    bodies in 48 ms, of which 20 ms in the ``tri`` site."""
    out = []
    for k in range(N + 1):
        tally_ns = {"keyframe": 48 * MS * k, "ba": 0, "k1": 0}
        if "tri" in sites:
            tally_ns["tri"] = 20 * MS * k
        out.append({"seq": k, "kind": "batch", "steps": C, "replays": C,
                    "device": {"graph": 3, "replay_ns": [], "tally": {"keyframe": 10 * k},
                               "tally_ns": tally_ns, "error_ns": 3_000}})
    return out


def _read(monkeypatch, records, traced=True):
    monkeypatch.setattr(window_chunks, "harvest", lambda: records)
    rec = {"chunk_card_ms": [170.0] * N} if traced else {}
    return harness.load_module("metrics", "fleet.tri_ms_per_step").read(rec)


def test_reads_the_tri_sites_ms_a_step(monkeypatch):
    assert _read(monkeypatch, _records()) == pytest.approx(20.0 * N / (N * C), rel=1e-12)


def test_reads_nothing_from_a_step_without_the_site(monkeypatch):
    """A program whose captured step stamps no ``tri`` site reads None."""
    assert _read(monkeypatch, _records(sites=())) is None


def test_reads_nothing_without_records_or_a_traced_window(monkeypatch):
    assert _read(monkeypatch, None) is None
    assert _read(monkeypatch, _records()[1:]) is None
    assert _read(monkeypatch, _records(), traced=False) is None
