"""K1 (``fast_pyramid_maps``) inside the captured step: the least time for
its work at the cell's shapes (``rec["k1"]["least_ms"]``, as
``k1_roofline``) over its span in the step (the ``k1`` stamps around its
launch in ``extract_batch``, one launch a replay), in percent."""

from slambench.chunks import delta, replays, window


def read(rec):
    chunks = window(rec)
    k = rec.get("k1")
    ns = delta(chunks, "tally_ns", "k1") if chunks and k else None
    if not ns:
        return None
    return 100.0 * k["least_ms"] / (ns / 1e6 / replays(chunks))
