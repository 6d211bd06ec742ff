"""The window's chunks in the port's span records
(``tinyslam_tpu_torch/utils/spans.py``), for the per-layer metrics that
read spans and counters from inside the captured step.

A traffic driver runs one chunk in set-up (the capture and its warm-up),
then the window's N chunks, N = ``len(rec["chunk_card_ms"])`` in a traced
run: the process's chunks 0 and 1..N.  Where the program keeps no such
records, or lacks any of these chunks or its device part, the metrics
read nothing (None) and are left out of the line."""

from __future__ import annotations


def harvest():
    """The program's chunk records (synchronizes the card once); None
    where the program keeps none."""
    try:
        from tinyslam_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.records()


def window(rec: dict):
    """Chunks 0..N, each with its device part, all from one captured graph
    (chunk 0, the set-up's, is the baseline of the cumulative tallies);
    None where any is missing."""
    n = len(rec.get("chunk_card_ms") or ())
    records = harvest() if n else None
    if not records:
        return None
    by_seq = {r["seq"]: r for r in records}
    chunks = [by_seq.get(i) for i in range(n + 1)]
    if any(c is None or c["device"] is None for c in chunks):
        return None
    if len({c["device"]["graph"] for c in chunks}) != 1:
        return None
    return chunks


def replays(chunks: list) -> int:
    """The window's replays (one a step on which some stream was active)."""
    return sum(c["replays"] for c in chunks[1:])


def delta(chunks: list, key: str, name: str):
    """The window's growth of the cumulative counter ``key`` (``tally`` or
    ``tally_ns``) at ``name``; None where the capture has no such slot."""
    first, last = chunks[0]["device"][key], chunks[-1]["device"][key]
    if name not in first or name not in last:
        return None
    return last[name] - first[name]


def replay_ns(chunks: list) -> list[int]:
    """The window's replay spans, in nanoseconds."""
    return [e - b for c in chunks[1:] for b, e in c["device"]["replay_ns"]]
