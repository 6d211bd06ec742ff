"""Card milliseconds a step in the keyframe bodies' triangulations (each
keyframe's two ``_triangulate_and_insert`` calls, the ``tri`` site), by
their device stamps, over the window's replays."""

from slambench.chunks import delta, replays, window


def read(rec):
    chunks = window(rec)
    ns = delta(chunks, "tally_ns", "tri") if chunks else None
    n = replays(chunks) if chunks else 0
    return ns / n / 1e6 if ns is not None and n else None
