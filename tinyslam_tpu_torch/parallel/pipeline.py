"""Front-end / back-end pipelining (mirrors
``tinyslam_tpu/parallel/pipeline.py:AsyncWorker``).

SLAM has one latency-critical stage (per-frame tracking) and one
throughput stage (the pose-graph solve after a loop closure).  Here the
two decouple: tracking keeps going while the back-end solves on a worker
thread, and the correction is applied at the next frame boundary.  The job
slot is latest-wins: a newer graph snapshot contains every edge of an
older one, so a snapshot not yet started is replaced, not queued.

PyTorch releases the interpreter lock inside its kernels and copies, so
the worker and the tracker overlap; on a GPU the worker's caller gives the
solve a CUDA stream of its own (``models/slam.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional


class AsyncWorker:
    """Single background worker with a latest-wins job slot.

    submit(fn)  schedule fn() on the worker; replaces any job not yet
                started (the newer snapshot subsumes the older).
    poll()      non-blocking: the newest finished result, or None; raises
                the error of a failed job.
    flush()     block until no job is pending or running, return poll().
    close()     stop the thread (a pending job is dropped).
    """

    def __init__(self, name: str = "tinyslam-backend"):
        self._cond = threading.Condition()
        self._job: Optional[Callable[[], Any]] = None
        self._running = False
        self._result: Any = None
        self._has_result = False
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            with self._cond:
                while self._job is None and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                fn = self._job
                self._job = None
                self._running = True
            try:
                out, err = fn(), None
            except BaseException as e:  # noqa: BLE001 - surfaced on the next poll()
                out, err = None, e
            with self._cond:
                self._running = False
                if err is not None:
                    self._error = err
                else:
                    self._result = out
                    self._has_result = True
                self._cond.notify_all()

    def submit(self, fn: Callable[[], Any]) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("worker is closed")
            self._job = fn
            self._cond.notify_all()

    def poll(self):
        with self._cond:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._has_result:
                self._has_result = False
                out, self._result = self._result, None
                return out
            return None

    def flush(self):
        with self._cond:
            while self._job is not None or self._running:
                self._cond.wait()
        return self.poll()

    @property
    def busy(self) -> bool:
        with self._cond:
            return self._job is not None or self._running

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def abandon(self) -> None:
        """Stop the loop without joining the thread, which may be hung in a
        job: its late result is dropped with this object."""
        with self._cond:
            self._closed = True
            self._job = None
            self._cond.notify_all()

    def close(self):
        self.abandon()
        self._thread.join(timeout=5.0)
