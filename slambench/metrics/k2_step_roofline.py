"""K2 (``match_reduce``) inside the captured step: the least time for its
work at the guided shape (``rec["k2"]["least_ms"]``, as ``k2_roofline``)
over its span in the step (the ``k2.track`` stamps around its launch in
the guided pass, one a replay, and in the second pass, one a
``second_pass`` body), in percent."""

from slambench.chunks import delta, replays, window


def read(rec):
    chunks = window(rec)
    k = rec.get("k2")
    ns = delta(chunks, "tally_ns", "k2.track") if chunks and k else None
    second = delta(chunks, "tally", "second_pass") if ns else None
    if not ns or second is None:
        return None
    return 100.0 * k["least_ms"] / (ns / 1e6 / (replays(chunks) + second))
