"""Keyframes inserted a 1,000 frames over all streams: the growth of the
captured step's ``keyframe`` tally (counted on the card, summed over
rows) over the window's frames."""

from slambench.chunks import delta, window


def read(rec):
    chunks = window(rec)
    k = delta(chunks, "tally", "keyframe") if chunks else None
    return 1e3 * k / rec["attempted"] if k is not None and rec.get("attempted") else None
