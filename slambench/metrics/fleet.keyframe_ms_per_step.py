"""Card milliseconds a step in the keyframe bodies of the captured step
(each row's keyframe insertion with its window BA), by the bodies' device
stamps, over the window's replays."""

from slambench.chunks import delta, replays, window


def read(rec):
    chunks = window(rec)
    ns = delta(chunks, "tally_ns", "keyframe") if chunks else None
    n = replays(chunks) if chunks else 0
    return ns / n / 1e6 if ns is not None and n else None
