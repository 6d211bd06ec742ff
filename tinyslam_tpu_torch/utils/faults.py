"""Failure detection, snapshots and recovery (mirrors
``tinyslam_tpu/utils/faults.py``).

- ``Watchdog`` supervises the asynchronous back-end: a dead worker thread
  or a solve past its deadline is detected at the next frame boundary,
  and the worker is rebuilt with the interrupted job resubmitted, so
  tracking never blocks on, or dies with, the back-end.
- ``SnapshotPolicy`` checkpoints a tracker every N keyframes
  (``utils/checkpoint.py``) and keeps the newest few; ``restore_latest``
  brings a fresh instance back to the newest intact one and forces a
  relocalization against the restored map on its next frame.
- ``Heartbeat`` probes the device on a side thread with a deadline, so a
  hung card reports dead instead of blocking the caller for ever.
"""

from __future__ import annotations

import shutil
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from tinyslam_tpu_torch.parallel.pipeline import AsyncWorker
from tinyslam_tpu_torch.utils.checkpoint import restore_slam, restore_vo, save_slam, save_vo


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


class SnapshotPolicy:
    """Checkpoint on keyframes, with a bounded history.

    ``maybe_snapshot(system)`` saves when ``num_keyframes`` has advanced by
    ``every_keyframes`` since the last snapshot, into
    ``directory/snap_<keyframes>``, and keeps the newest ``keep``.  It takes
    a tracker (``VisualOdometry``, ``DeviceVO``) or a ``Slam``/``DeviceSlam``.
    """

    def __init__(self, directory, every_keyframes: int = 5, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = every_keyframes
        self.keep = keep
        self._last_kf = 0
        self.skipped: list[tuple[Path, str]] = []   # (snapshot, error) restore skipped

    def maybe_snapshot(self, system) -> Optional[Path]:
        n = getattr(system, "vo", system).num_keyframes
        if n - self._last_kf < self.every:
            return None
        self._last_kf = n
        path = self.dir / f"snap_{n:06d}"
        (save_slam if hasattr(system, "vo") else save_vo)(system, path)
        for old in self.snapshots()[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)
        return path

    def snapshots(self) -> list[Path]:
        return sorted(p for p in self.dir.glob("snap_*") if p.is_dir())

    def restore_latest(self, system) -> Optional[Path]:
        """Restore the newest intact snapshot into a fresh instance, newest
        first past corrupt ones (a crash mid-save), and force a global
        relocalization on its next frame: the world moved on between the
        snapshot and the crash, so the restored pose is stale.  Returns the
        snapshot, or None if none restores."""
        for path in reversed(self.snapshots()):
            try:
                (restore_slam if hasattr(system, "vo") else restore_vo)(system, path)
            except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile) as exc:
                self.skipped.append((path, repr(exc)))
                continue
            getattr(system, "vo", system).force_reloc = True
            return path
        return None


class Heartbeat:
    """Deadline-bounded liveness probe of a device.

    ``beat()`` runs ``probe_fn`` on a daemon thread and waits at most
    ``timeout_s`` for it; it returns True if the probe answered, and counts
    ``missed`` beats in a row otherwise, so a hung device reports dead
    instead of blocking the control loop.  The default probe adds one on
    ``device`` (the card if None) and reads the element back.  A probe
    that raises is a missed beat (``last_error``).
    """

    def __init__(self, probe_fn: Optional[Callable[[], Any]] = None,
                 timeout_s: float = 5.0, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if probe_fn is None:
            def probe_fn():
                x = torch.zeros((), dtype=torch.float32, device=self.device)
                return float((x + 1.0).cpu())
        self._probe = probe_fn
        self.timeout_s = timeout_s
        self.missed = 0
        self.last_error: Optional[BaseException] = None

    def beat(self) -> bool:
        done = threading.Event()
        result = {}

        def _run():
            try:
                self._probe()
                result["ok"] = True
            except Exception as exc:          # noqa: BLE001 - reported, not raised
                result["error"] = exc
            finally:
                done.set()

        threading.Thread(target=_run, daemon=True, name="tinyslam-heartbeat").start()
        alive = done.wait(self.timeout_s) and result.get("ok", False)
        if "error" in result:
            self.last_error = result["error"]
        self.missed = 0 if alive else self.missed + 1
        return alive
