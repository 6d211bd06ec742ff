"""Card milliseconds a replay of the batched tracker's captured step: from
the step's first stamp to its last (``tinyslam_tpu_torch/utils/spans.py``),
over the window's replays.  Unlike ``fleet.card_ms_per_step`` it leaves
out the chunk's upload, the copies between replays and the waits for the
host's launches."""

from slambench.chunks import replay_ns, window


def read(rec):
    chunks = window(rec)
    spans = replay_ns(chunks) if chunks else None
    return sum(spans) / len(spans) / 1e6 if spans else None
