"""K1 (the fused FAST stage, ``fast_pyramid_maps``) at the cell's pyramid:
the least time for its work (``counts/k1.py``) over its device time, in
percent."""


def read(rec):
    k = rec.get("k1")
    return 100.0 * k["least_ms"] / k["ms"] if k and k["ms"] > 0 else None
