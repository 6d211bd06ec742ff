"""Supervision of the asynchronous back-end (mirrors
``tinyslam_tpu/utils/faults.py:Watchdog``).

A dead worker thread or a solve past its deadline is detected at the next
frame boundary, and the worker is rebuilt with the interrupted job
resubmitted: tracking never blocks on, or dies with, the back-end.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from tinyslam_tpu_torch.parallel.pipeline import AsyncWorker


class Watchdog:
    """Supervised ``AsyncWorker`` with a deadline and a liveness check,
    with the worker's submit/poll/flush/close surface.

    ``check()`` (called by ``poll`` and ``flush``, or any time) probes that
    the worker thread is alive and that the running job has not exceeded
    ``solve_timeout_s``.  On a fault the worker is replaced and the job is
    resubmitted once (``resubmit``), so a crashed solve is retried, not lost.
    """

    def __init__(self, solve_timeout_s: float = 30.0, resubmit: bool = True,
                 name: str = "tinyslam-backend"):
        self.solve_timeout_s = solve_timeout_s
        self.resubmit = resubmit
        self._name = name
        self.worker = AsyncWorker(name)
        self.restarts = 0
        self._last_fn: Optional[Callable[[], Any]] = None
        self._submitted_at = 0.0
        self._lock = threading.Lock()

    def submit(self, fn: Callable[[], Any]) -> None:
        with self._lock:
            self._last_fn = fn
            self._submitted_at = time.monotonic()
            self.worker.submit(fn)

    def poll(self):
        self.check()
        return self.worker.poll()

    def flush(self):
        # A flush on a hung worker would block forever: bound it by the
        # deadline and restart instead.
        deadline = time.monotonic() + self.solve_timeout_s
        while self.worker.busy and self.worker.alive:
            if time.monotonic() > deadline:
                self.check(force_stuck=True)
                break
            time.sleep(0.005)
        self.check()
        return self.worker.poll()

    def close(self):
        self.worker.close()

    @property
    def busy(self) -> bool:
        return self.worker.busy

    def check(self, force_stuck: bool = False) -> str:
        """Probe the worker; rebuild it on a fault.  Returns "ok",
        "restarted-dead" or "restarted-stuck"."""
        with self._lock:
            dead = not self.worker.alive
            stuck = force_stuck or (
                self.worker.busy and self._submitted_at > 0
                and time.monotonic() - self._submitted_at > self.solve_timeout_s)
            if not dead and not stuck:
                return "ok"
            self.worker.abandon()
            self.worker = AsyncWorker(self._name)
            self.restarts += 1
            if self.resubmit and self._last_fn is not None:
                self._submitted_at = time.monotonic()
                self.worker.submit(self._last_fn)
            return "restarted-dead" if dead else "restarted-stuck"
