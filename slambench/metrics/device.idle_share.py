"""The share of the traced run's window in which the card had no chunk of
the program's in flight: 1 minus the CUDA-event spans around the chunks'
uploads and tracker calls (``chunk_card_ms``), summed, over the window's
wall time.  No profiler runs in the window.  A span also holds the gaps
in which the card waits, inside a chunk, for the host to launch the next
graph replay, so this share is a lower bound of the card's idle time: what
it shows is the host's work between chunks (gathering frames, reading
poses back)."""


def read(rec):
    ms = rec.get("chunk_card_ms")
    if not ms or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - sum(ms) / (1e3 * rec["window_s"]))
