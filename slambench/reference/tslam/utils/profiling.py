"""Profiling helpers (mirrors ``tinyslam_tpu/utils/profiling.py``).

- ``trace`` / ``named_scope``: a ``torch.profiler`` trace of a block,
  written as a Chrome trace (Perfetto, ``chrome://tracing``); the front-end
  labels each pyramid level's work ``orb_level{n}`` (``frontend/orb.py``),
  so its ops group by level in the trace.
- ``readback_sync`` / ``dispatch_slope``: wall-clock timing of calls that
  return before the device has finished.  ``dispatch_slope`` times 1 call
  and ``reps`` back-to-back calls, each sequence ended by one readback,
  and returns the slope: the fixed cost of a synchronization cancels and
  the per-call time remains.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

named_scope = torch.profiler.record_function


@contextmanager
def trace(log_dir=None, device=None, *, cpu: bool = True):
    """Profile the enclosed block and write ``trace.json`` (Chrome format)
    into ``log_dir`` (a new temporary directory if None), which the block
    receives::

        with profiling.trace("build/trace") as d:
            feats = frontend.extract(frame)

    CPU activity unless ``cpu`` is False (a trace of the card alone is
    smaller and slows the host's launches less); CUDA activity where
    ``device`` is CUDA, with a synchronize before the trace stops.
    ``device`` None means the card: without one it raises; a trace of the
    CPU alone asks for ``"cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("profiling.trace: no CUDA device to trace; pass "
                               "device='cpu' to trace the CPU alone")
        device = "cuda"
    cuda = torch.device(device).type == "cuda"
    activities = ([ProfilerActivity.CPU] if cpu else []) + ([ProfilerActivity.CUDA] if cuda else [])
    if not activities:
        raise ValueError("profiling.trace: cpu=False traces nothing on a CPU device")
    log_dir = Path(tempfile.mkdtemp(prefix="tinyslam_trace_") if log_dir is None else log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if cuda:
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _first_tensor(out):
    """The first tensor leaf of nested dicts (keys in sorted order, as JAX
    orders a pytree), lists, tuples and dataclasses; None if there is none."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        children = [out[k] for k in sorted(out)]
    elif isinstance(out, (list, tuple)):
        children = out
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        children = [getattr(out, f.name) for f in dataclasses.fields(out)]
    else:
        return None
    for child in children:
        leaf = _first_tensor(child)
        if leaf is not None:
            return leaf
    return None


def readback_sync(out) -> None:
    """Block until ``out`` is computed, by reading one element of its first
    tensor leaf back to the host."""
    leaf = _first_tensor(out)
    if leaf is not None:
        leaf.reshape(-1)[:1].cpu()


def dispatch_slope(fn, inputs, reps: int = 9, attempts: int = 3) -> float:
    """Per-call seconds of ``fn`` over ``inputs`` (a list of argument
    tuples, or of single arguments), from the slope between 1 call and
    ``reps`` back-to-back calls, each run ended by one readback; the
    minimum over ``attempts`` rejects scheduler noise."""
    inputs = [x if isinstance(x, tuple) else (x,) for x in inputs]
    readback_sync(fn(*inputs[0]))

    def run_k(k: int) -> float:
        t0 = time.perf_counter()
        for i in range(k):
            r = fn(*inputs[i % len(inputs)])
        readback_sync(r)
        return time.perf_counter() - t0

    d1 = min(run_k(1) for _ in range(attempts))
    dr = min(run_k(reps) for _ in range(attempts))
    return max((dr - d1) / (reps - 1), 1e-9)
