"""What the benchmark reads on the card around calls into the program: CUDA
event pairs, and one ``torch.profiler`` stretch reduced to the device's
busy time, its idle gaps and its longest operations.

The profiler runs last in a traced run: once it has run in a process,
every later CUDA graph launch of that process costs more on the host.
Under it each ``cudaGraphLaunch`` takes several times as long, and the
card waits for those launches, so on the graph path the profiled stretch
reads far more idle time than the same chunks untraced.  Its busy time
(``busy_s``, ``window_s``) and its operations and gaps by name go to the
result's ``device`` and ``breakdown``; the per-layer idle share is taken
from CUDA events in the unprofiled window instead.
"""

from __future__ import annotations

import time

import torch

TOP = 10
NAME = 160                  # characters of an operation's name kept


class EventPairs:
    """CUDA event pairs on the current stream, read after the window."""

    def __init__(self):
        self.pairs: list[tuple] = []

    def start(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, start) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.append((start, ev))

    def ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


def launch_ms(fn, reps: int) -> float:
    """Device milliseconds a call of ``fn`` (which must not synchronize),
    from CUDA events around ``reps`` calls that the host queued while a
    sleep kernel held the stream: the events then time the device alone,
    with no gap for the host's launch overhead (``chip_smoke.py``'s
    ``_queued_ms``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # Twice the time the host took to queue the calls, at up to 2 GHz.
    torch.cuda._sleep(int(2e9 * (2 * enqueue_s + 2e-3)))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _events(prof):
    """(device operations, host ranges) of a trace as (start s, end s, name);
    a host range (``record_function``) shows on the device's timeline too,
    as an annotation spanning its launches, which is not an operation."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        item = (s, s + e.duration_ns() * 1e-9, e.name())
        (dev if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(item)
    names = {name for _, _, name in host}
    return [d for d in dev if d[2] not in names], host


def _marker():
    torch.cuda._sleep(1000)


def profiled(step, n: int) -> dict:
    """Run ``step(i)`` for i < n under the profiler, tracing the card alone
    (recording the host's calls too slows its launches), between two marker
    kernels, and reduce the trace: {"busy_s": seconds in which some device
    operation ran, "window_s": from the first marker's start to the last's
    end, "device_ops": the operations that took most time, by name}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _marker()
        for i in range(n):
            step(i)
        _marker()
        torch.cuda.synchronize()
    dev, _ = _events(prof)
    if not dev:
        raise RuntimeError("slambench: the profiler's trace holds no device operation")
    # torch.cuda._sleep's kernel is ATen's spin_kernel.
    marks = sorted(d for d in dev if "spin_kernel" in d[2] or "sleep" in d[2].lower())
    if len(marks) < 2:
        marks = sorted(dev)
    w0, w1 = marks[0][0], max(e for _, e, _ in marks)
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in dev if e > w0 and s < w1])
    by_name: dict[str, float] = {}
    for s, e, name in dev:
        if "spin_kernel" not in name:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(e - s for s, e in busy), "window_s": w1 - w0,
            "device_ops": [[name[:NAME], sec] for name, sec in ops]}


def idle_gaps(step, n: int) -> list:
    """The longest gaps between device operations while ``step(i)`` runs for
    i < n under the profiler with the host's calls recorded, each named by
    the innermost host call that spans its middle.  The recording slows the
    host's launches, so these gaps are longer than untraced ones."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("slambench.stretch"):
            for i in range(n):
                step(i)
            torch.cuda.synchronize()
    dev, host = _events(prof)
    window = [(s, e) for s, e, name in host if name == "slambench.stretch"]
    if not window or not dev:
        return []
    w0, w1 = window[0]
    host = [h for h in host if h[2] != "slambench.stretch"]
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in dev if e > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = (s + e) / 2
            inside = [(he - hs, name) for hs, he, name in host if hs <= mid <= he]
            gaps.append((e - s, min(inside)[1][:NAME] if inside else "host between calls"))
    gaps.sort(key=lambda g: -g[0])
    return [[name, sec] for sec, name in gaps[:TOP]]
