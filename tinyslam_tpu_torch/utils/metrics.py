"""Per-frame metrics registry (mirrors ``tinyslam_tpu/utils/metrics.py``).

Any stage can record named scalars (tracked features, inliers, stage
latency) under a frame step; the registry aggregates them on the host and
exports them as JSON.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager


class Metrics:
    def __init__(self):
        self._series: dict[str, list[tuple[int, float]]] = defaultdict(list)
        self._step = 0

    def step(self, step: int | None = None) -> int:
        self._step = self._step + 1 if step is None else step
        return self._step

    def record(self, name: str, value: float, step: int | None = None) -> None:
        self._series[name].append((self._step if step is None else step, float(value)))

    @contextmanager
    def timer(self, name: str):
        """Record the wall time of the block as ``name + "_ms"``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name + "_ms", (time.perf_counter() - t0) * 1e3)

    def last(self, name: str) -> float | None:
        s = self._series.get(name)
        return s[-1][1] if s else None

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, s in self._series.items():
            vals = sorted(v for _, v in s)
            out[name] = {"count": len(vals), "mean": sum(vals) / len(vals),
                         "min": vals[0], "max": vals[-1], "p50": vals[len(vals) // 2]}
        return out

    def to_json(self) -> str:
        return json.dumps(dict(self._series), separators=(",", ":"))

    def dump(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
