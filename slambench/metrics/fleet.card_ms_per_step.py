"""Card milliseconds a step of the batched tracker: a CUDA event pair on the
current stream around each chunk's upload and ``track_chunk_batch`` call,
summed over the window, over the window's steps (a step tracks one frame
of every stream)."""


def read(rec):
    ms = rec.get("chunk_card_ms")
    return sum(ms) / rec["steps"] if ms and rec.get("steps") else None
