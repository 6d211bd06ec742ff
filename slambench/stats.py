"""The arithmetic of the end-to-end rate over a whole window, and the
seed-drawn sample of chunks that the comparison replays."""

from __future__ import annotations

import numpy as np


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``seed`` (algorithm R): what the comparison replays after the
    window."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng(int(seed) % 2**63)
        self.seen = 0
        self.items: list = []

    def offer(self, make):
        """Offer the next item; ``make()`` builds it only if it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = make()
