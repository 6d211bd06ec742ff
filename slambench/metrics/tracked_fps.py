"""Tracked frames over all streams, over the whole window's wall time."""

from slambench.stats import rate


def read(rec):
    return rate(rec["tracked"], rec["window_s"])
