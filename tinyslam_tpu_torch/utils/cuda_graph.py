"""Data-dependent branches that a captured CUDA graph can hold: the
counterpart of ``lax.cond`` (``device_cond``), and the capture of a step
whose branches become conditional nodes (``capture``).

``device_cond(pred, true_fn, false_fn, operands)`` runs in one of three
ways, chosen by what surrounds the call:

- eagerly (the plain version, on the CPU and on the card): ``true_fn(
  *operands) if bool(pred) else false_fn(*operands)``, one read of
  ``pred`` on the host;
- inside ``warm(fn)``: both branches run, nothing is read back, and the
  true branch's result is returned.  One warm call of a step pays, before
  a capture, for everything a branch does the first time it runs (module
  loading, library handles, the kernels' build and caches);
- inside ``capture(fn, ...)``: two IF nodes, one on ``pred`` and one on
  its negation, each holding the capture of one branch; at a replay only
  the branch taken runs, as on the TPU.  The true branch's outputs are
  copied into fresh buffers inside its body and the false branch copies
  its own into those buffers, so that what follows the node reads one set
  of tensors.  CUDA nests conditional nodes (12.4 and later), so a branch
  may call ``device_cond`` again.

Both branches return the same structure (tensors in tuples, lists, dicts
and dataclasses) with the same shapes and dtypes, as ``lax.cond`` wants.
A branch may be named: during a capture each named body adds one to its
slot of a device tally when it runs, and the capture records the kernel
launches each body made (counted by ``counters`` while it was captured,
its nested bodies excluded), so that a caller can keep the kernels'
Python launch counters true under replays: a replay makes no Python call.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Callable

import torch

_MODE: contextvars.ContextVar = contextvars.ContextVar("tinyslam_cond_mode", default=None)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of tuples, lists, dicts (by sorted key) and
    dataclasses, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in tree_leaves(item)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    raise TypeError(f"device_cond: a branch returned a {type(tree).__name__}, not tensors")


def _rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in ``tree_leaves`` order, from the
    iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(item, leaves) for item in tree)
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return type(tree)(**{f.name: _rebuild(getattr(tree, f.name), leaves)
                         for f in dataclasses.fields(tree)})


def _same_form(a: list[torch.Tensor], b: list[torch.Tensor]) -> None:
    if len(a) != len(b) or any(x.shape != y.shape or x.dtype != y.dtype
                               for x, y in zip(a, b)):
        raise ValueError("device_cond: the branches return tensors of different number, "
                         "shape or dtype")


def device_cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
                operands: tuple = (), names: tuple = (None, None)):
    """``true_fn(*operands)`` where the 0-d bool ``pred`` holds, else
    ``false_fn(*operands)``; ``names`` names the two bodies for the tally
    of a capture (None: not counted).  See the module's docstring."""
    mode = _MODE.get()
    if mode is None:
        return true_fn(*operands) if bool(pred) else false_fn(*operands)
    if isinstance(mode, _Warm):
        out = mode.run(true_fn, operands)
        _same_form(tree_leaves(out), tree_leaves(mode.run(false_fn, operands)))
        return out
    return mode.if_else(pred, true_fn, false_fn, operands, names)


MAX_DEPTH = 4           # conditional nodes nested in one another


def _indexed(device) -> torch.device:
    """``device``, a card's with its index (streams are cached by it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _body_streams(device: torch.device) -> tuple:
    """The streams a body at each depth is captured on (and warmed on)."""
    return tuple(torch.cuda.Stream(device) for _ in range(MAX_DEPTH))


class _Warm:
    """Both branches of every ``device_cond`` run; on the card each body
    runs on the stream its capture will use, so that anything made there
    the first time (a library's workspace for the stream) exists before
    the capture."""

    def __init__(self, device):
        dev = None if device is None else _indexed(device)
        self.streams = _body_streams(dev) if dev is not None and dev.type == "cuda" else None
        self.depth = 0

    def run(self, fn: Callable, operands: tuple):
        if self.streams is None:
            return fn(*operands)
        cur, body = torch.cuda.current_stream(), self.streams[self.depth]
        body.wait_stream(cur)
        self.depth += 1
        try:
            with torch.cuda.stream(body):
                out = fn(*operands)
        finally:
            self.depth -= 1
        cur.wait_stream(body)
        return out


def warm(fn: Callable, device=None):
    """``fn()`` with every ``device_cond`` in it running both branches
    (on ``device``'s body streams where it is a card)."""
    token = _MODE.set(_Warm(device))
    try:
        return fn()
    finally:
        _MODE.reset(token)


def _route_thread_to_pool(index: int, pool) -> None:
    """Inside a capture into ``pool``: send every allocation of this
    thread, on any stream, to the pool.  A capture sends only those on
    streams capturing into its own graph, and a conditional node's body is
    captured into a graph of its own; one pool may have one router, so
    this replaces the capture's (PyTorch's private calls: the use count
    the second ``begin`` adds is released, and the capture's end removes
    this router)."""
    C = torch._C
    C._cuda_endAllocateToPool(index, pool)
    C._cuda_beginAllocateCurrentThreadToPool(index, pool)
    C._cuda_releasePool(index, pool)


class _Recorder:
    """The state of one capture: the tally's slots, the launches of each
    named body, and the streams of the bodies."""

    def __init__(self, names: tuple, counters: Callable, device: torch.device):
        self.device = device
        self.streams = _body_streams(device)
        self.slots = {name: i for i, name in enumerate(names)}
        self.tally = torch.zeros(len(names), dtype=torch.int32, device=device)
        self.counters = counters
        self.body_launches: dict[str, tuple] = {}
        self.in_bodies = [0] * len(counters())   # launches inside the outermost bodies
        self._nested: list[list[int]] = []      # launches inside each open body's bodies

    def _body(self, pred: torch.Tensor, negate: bool, name, make: Callable):
        """Capture ``make()`` into an IF node on ``pred`` (or its negation);
        returns its result."""
        from tinyslam_tpu_torch.ops import cuda_build

        if name is not None and name not in self.slots:
            raise KeyError(f"device_cond: no tally slot {name!r}")
        depth = len(self._nested)
        if depth >= MAX_DEPTH:
            raise ValueError(f"device_cond: more than {MAX_DEPTH} nested conditions")
        lib = cuda_build.load_library()
        body = self.streams[depth]
        start = self.counters()
        cuda_build.check(lib.tinyslam_graph_if_begin(
            torch.cuda.current_stream(self.device).cuda_stream, pred.data_ptr(), int(negate),
            body.cuda_stream), "tinyslam_graph_if_begin")
        self._nested.append([0] * len(start))
        try:
            with torch.cuda.stream(body):
                out = make()
                if name is not None:
                    i = self.slots[name]
                    self.tally[i:i + 1].add_(1)
        except BaseException:
            lib.tinyslam_graph_if_end(body.cuda_stream)     # the first error stands
            raise
        cuda_build.check(lib.tinyslam_graph_if_end(body.cuda_stream), "tinyslam_graph_if_end")
        inner = self._nested.pop()
        total = [b - a for a, b in zip(start, self.counters())]
        own = tuple(t - i for t, i in zip(total, inner))
        if name is None and any(own):
            raise ValueError("device_cond: an unnamed branch launched kernels that no "
                             "tally slot counts")
        if name is not None and self.body_launches.setdefault(name, own) != own:
            raise ValueError(f"device_cond: body {name!r} captured twice with "
                             f"{self.body_launches[name]} and {own} launches")
        outer = self._nested[-1] if self._nested else self.in_bodies
        outer[:] = [a + b for a, b in zip(outer, total)]
        return out

    def if_else(self, pred, true_fn, false_fn, operands, names):
        # One byte the two set_condition launches read, alive across both.
        pred = pred.reshape(()).to(torch.bool).contiguous()

        def first():
            out = true_fn(*operands)
            return out, [x.clone() for x in tree_leaves(out)]

        def second():
            other = tree_leaves(false_fn(*operands))
            _same_form(merged, other)
            for dst, src in zip(merged, other):
                dst.copy_(src)

        out, merged = self._body(pred, False, names[0], first)
        self._body(pred, True, names[1], second)
        return _rebuild(out, iter(merged))


_ABANDONED: list = []


def _abandon(graph, index: int, pool) -> None:
    """End a capture that failed.  Where the capture was invalidated,
    ``capture_end`` raises before it stops sending allocations to the
    pool; stop that here, or the next allocation goes to a dead pool.  The
    graph is kept, never destroyed: a conditional node whose body's
    capture was invalidated crashes the process when its graph is destroyed."""
    _ABANDONED.append(graph)
    try:
        graph.capture_end()
    except RuntimeError:
        try:
            torch._C._cuda_endAllocateToPool(index, pool)
        except RuntimeError:
            pass        # the capture had stopped the routing itself


@dataclass
class Captured:
    """A captured and instantiated graph, what ``fn`` returned while it was
    captured (tensors the replays rewrite), the tally, and the launches:
    ``base`` those of the graph outside every conditional body (one set a
    replay), ``body_launches[name]`` those of a named body (one set each
    time it runs)."""

    graph: torch.cuda.CUDAGraph
    outputs: object
    names: tuple
    tally: torch.Tensor
    base: tuple
    body_launches: dict
    capture_s: float
    instantiate_s: float
    pool_bytes: int


def capture(fn: Callable, device, names: tuple, counters: Callable) -> Captured:
    """Capture ``fn()`` (on a side stream, after a synchronize) into a CUDA
    graph whose ``device_cond``s are conditional nodes, and instantiate it.
    ``counters()`` returns the kernels' Python launch counters (the capture
    advances them once for every body; the caller restores them).  Raises
    where the capture fails: the caller never falls back to running ``fn``
    eagerly."""
    dev = _indexed(device)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    pool = torch.cuda.graph_pool_handle()
    rec = _Recorder(tuple(names), counters, dev)
    stream = torch.cuda.Stream(dev)
    torch.cuda.synchronize(dev)
    reserved = torch.cuda.memory_reserved(dev)
    start = counters()
    t0 = time.perf_counter()
    token = _MODE.set(rec)
    try:
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                _route_thread_to_pool(dev.index, pool)
                outputs = fn()
            except BaseException:
                _abandon(graph, dev.index, pool)
                raise
            graph.capture_end()
    finally:
        _MODE.reset(token)
    t1 = time.perf_counter()
    graph.instantiate()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    base = tuple(b - a - i for a, b, i in zip(start, counters(), rec.in_bodies))
    return Captured(graph=graph, outputs=outputs, names=tuple(names), tally=rec.tally,
                    base=base, body_launches=dict(rec.body_launches), capture_s=t1 - t0,
                    instantiate_s=t2 - t1,
                    pool_bytes=torch.cuda.memory_reserved(dev) - reserved)
