"""K2 (the streaming Hamming matcher, ``match_reduce``) at the cell's guided
shape: the least time for its work (``counts/k2.py``) over its device
time, in percent."""


def read(rec):
    k = rec.get("k2")
    return 100.0 * k["least_ms"] / k["ms"] if k and k["ms"] > 0 else None
