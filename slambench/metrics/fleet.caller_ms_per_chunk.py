"""Host milliseconds a chunk spent outside the program between chunks: a
chunk's entry into the tracker minus the previous chunk's last replay's
end on the card, both on the host's clock (the card's stamps mapped by
the recorder's calibration).  That is the caller's read-back of poses and
summaries, its gather of the next frames and its upload; averaged over
the window's chunks after its first."""

from slambench.chunks import window


def read(rec):
    chunks = window(rec)
    if not chunks or len(chunks) < 3:
        return None
    gaps = [c["host_ns"]["entry"] - p["device"]["replay_ns"][-1][1]
            for p, c in zip(chunks[1:], chunks[2:]) if p["device"]["replay_ns"]]
    return sum(gaps) / len(gaps) / 1e6 if len(gaps) == len(chunks) - 2 else None
