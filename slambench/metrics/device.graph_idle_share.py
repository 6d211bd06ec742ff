"""The share of the traced run's window in which no replay of the captured
step ran on the card: 1 minus the replays' device spans (first stamp to
last), summed, over the window's wall time.  The spans leave out the
uploads and the copies between replays, so this share is an upper bound
of the card's idle time, where ``device.idle_share`` is a lower one."""

from slambench.chunks import replay_ns, window


def read(rec):
    chunks = window(rec)
    spans = replay_ns(chunks) if chunks else None
    if not spans or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - sum(spans) / 1e9 / rec["window_s"])
