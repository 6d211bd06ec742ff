"""Data-dependent branches and loops that a captured CUDA graph can hold:
the counterparts of ``lax.cond`` (``device_cond``) and of a ``lax.scan``
of fixed length (``device_loop``), the capture of a step whose branches
and loops become conditional nodes (``capture``), and a function over
static buffers captured whole (``Program``).

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
launches each body made (counted by ``launch_counters`` while it was
captured, its nested bodies excluded), so that a caller can keep the
kernels' Python launch counters true under replays: a replay makes no
Python call (``add_launches``).  Each named body also adds the
nanoseconds it ran to its slot of the capture's ``tally_ns``, and a step
captured with names records each replay's span on the card, by stamp
kernels that read the card's timer (``utils/spans.py``);
``device_span(name)`` stamps a site that is not a body, into a slot that
the capture names in ``sites``.

``device_loop(iters, step, carry)`` runs ``carry, y = step(carry)``
``iters`` times and returns the last carry and the ys stacked: eagerly a
Python loop (the plain version); inside ``warm`` one turn; inside
``capture`` one WHILE node whose body is one turn's capture, so that a
capture records one turn however many it runs (a loop's body holds no
branch, and no loop is nested in a branch).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
import functools
import threading
import time
from dataclasses import dataclass
from typing import Callable

import torch

from tinyslam_tpu_torch.utils import spans

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
        out = mode.run(true_fn, operands, names[0])
        _same_form(tree_leaves(out), tree_leaves(mode.run(false_fn, operands, names[1])))
        return out
    return mode.if_else(pred, true_fn, false_fn, operands, names)


def device_loop(iters: int, step: Callable, carry):
    """``iters`` turns of ``carry, y = step(carry)``; returns the last
    carry and the ys stacked (iters, ...).  The carry keeps its structure,
    shapes and dtypes from turn to turn.  See the module's docstring."""
    mode = _MODE.get()
    if mode is None:
        ys = []
        for _ in range(iters):
            carry, y = step(carry)
            ys.append(y)
        return carry, torch.stack(ys)
    if isinstance(mode, _Warm):
        carry, y = mode.run(step, (carry,))
        return carry, y[None].expand(iters, *y.shape).clone()
    return mode.loop(iters, step, carry)


@contextlib.contextmanager
def device_span(name: str | None):
    """Stamp the work launched inside the ``with`` as the span ``name``:
    inside a capture whose ``sites`` name it, its nanoseconds add up in the
    capture's ``tally_ns``; inside ``warm`` the stamps run into a scratch
    buffer; eagerly, or for a name the capture lacks, nothing."""
    mode = _MODE.get()
    if mode is None or name is None:
        yield
        return
    with mode.span(name):
        yield


MAX_DEPTH = 4           # conditional nodes nested in one another


def indexed_device(device) -> torch.device:
    """``device``, a card's with its index (streams and graphs are cached
    by it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _graph_streams(device: torch.device) -> tuple:
    """The stream a capture runs on, then the stream a body at each depth
    is captured on (and warmed on), taken from PyTorch's pool together.
    The pool hands its 32 streams out in turn, so a stream taken at each
    capture would, after enough others, be a body's stream: a body's
    capture would then begin on a stream already capturing."""
    return tuple(torch.cuda.Stream(device) for _ in range(MAX_DEPTH + 1))


def _body_streams(device: torch.device) -> tuple:
    return _graph_streams(device)[1:]


class _Warm:
    """Both branches of every ``device_cond`` run; on the card each body
    runs on the stream its capture will use, so that anything made there
    the first time (a library's workspace for the stream) exists before
    the capture."""

    def __init__(self, device, stamped: tuple = ()):
        dev = None if device is None else indexed_device(device)
        card = dev is not None and dev.type == "cuda"
        self.streams = _body_streams(dev) if card else None
        self.stamps = spans.Stamps(stamped, dev) if card and stamped else None
        self.depth = 0

    def run(self, fn: Callable, operands: tuple, name=None):
        if self.streams is None:
            return fn(*operands)
        cur, body = torch.cuda.current_stream(), self.streams[self.depth]
        body.wait_stream(cur)
        self.depth += 1
        try:
            with torch.cuda.stream(body):
                with self.span(name):
                    out = fn(*operands)
        finally:
            self.depth -= 1
        cur.wait_stream(body)
        return out

    def span(self, name):
        """The spans the capture will stamp, into a scratch buffer."""
        if self.stamps is None:
            return contextlib.nullcontext()
        return self.stamps.span(name)


def warm(fn: Callable, device=None, names: tuple = (), sites: tuple = ()):
    """``fn()`` with every ``device_cond`` in it running both branches
    (on ``device``'s body streams where it is a card).  Given the
    ``names`` and ``sites`` of the ``capture`` to come, it runs on a card
    the stamps that the capture will hold, into a scratch buffer."""
    mode = _Warm(device, tuple(names) + tuple(sites))
    token = _MODE.set(mode)
    try:
        if mode.stamps is not None:
            mode.stamps.step_begin()
        out = fn()
        if mode.stamps is not None:
            mode.stamps.step_end()
        return out
    finally:
        _MODE.reset(token)


# Held while a step is warmed under the sync check below and while a
# ``Program`` is captured: PyTorch's sync debug mode is one setting for the
# whole process, so a readback on another thread in that window would raise
# there.  A thread that replays and reads back while a capture may be under
# way on another (the SLAM back-end's worker) holds it around both.
CAPTURE_LOCK = threading.RLock()


def warm_checked(fn: Callable, device, names: tuple = (), sites: tuple = ()) -> None:
    """``warm(fn, device, names, sites)`` twice, the second time with every
    synchronizing call an error: a step that reads the device back cannot
    be captured, and a capture broken midway leaves the device's graph
    objects in a state that is not safe to destroy.  Raises where ``fn``
    synchronizes."""
    warm(fn, device, names, sites)
    with CAPTURE_LOCK:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            warm(fn, device, names, sites)
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def _counted():
    """The modules of the port's kernels, in ``launch_counters`` order."""
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda, scatter_cuda

    return fast_cuda, match_cuda, scatter_cuda, dupband_cuda


def launch_counters() -> tuple[int, int, int, int]:
    """The Python launch counters of the port's kernels: K1
    (``ops/fast_cuda.py``), K2 (``ops/match_cuda.py``), the pose graph's
    assembly (``ops/scatter_cuda.py``) and the triangulation's duplicate
    test and local band (``ops/dupband_cuda.py``)."""
    return tuple(m.LAUNCHES for m in _counted())


def add_launches(launches) -> None:
    """Add ``launches`` (one number a counter of ``launch_counters``) to
    the kernels' counters."""
    for m, k in zip(_counted(), launches, strict=True):
        m.LAUNCHES += int(k)


@contextlib.contextmanager
def counters_kept():
    """Restore the kernels' launch counters on leaving: launches made while
    warming or capturing a step are none of the main path's."""
    saved = launch_counters()
    try:
        yield
    finally:
        for m, k in zip(_counted(), saved):
            m.LAUNCHES = k


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
    """The state of one capture: the tally's slots, the stamps of the step,
    of its named bodies and of its ``sites``, the launches of each named
    body, and the streams of the bodies."""

    def __init__(self, names: tuple, device: torch.device, sites: tuple = ()):
        self.device = device
        self.streams = _body_streams(device)
        self.slots = {name: i for i, name in enumerate(names)}
        self.tally = torch.zeros(len(names), dtype=torch.int32, device=device)
        stamped = tuple(names) + tuple(sites)
        self.stamps = spans.Stamps(stamped, device) if stamped else None
        self.body_launches: dict[str, tuple] = {}
        self.in_bodies = [0] * len(launch_counters())  # launches inside the outermost bodies
        self.in_loops = [0] * len(self.in_bodies)  # launches of the loops' later turns
        self.turns: list[torch.Tensor] = []      # each loop's turn counter
        self._nested: list[list[int]] = []      # launches inside each open body's bodies
        self._looping = False

    def _body(self, pred: torch.Tensor, negate: bool, name, make: Callable):
        """Capture ``make()`` into an IF node on ``pred`` (or its negation);
        returns its result."""
        from tinyslam_tpu_torch.ops import cuda_build

        if name is not None and name not in self.slots:
            raise KeyError(f"device_cond: no tally slot {name!r}")
        if self._looping:
            raise ValueError("device_cond: a branch inside a device_loop's body")
        depth = len(self._nested)
        if depth >= MAX_DEPTH:
            raise ValueError(f"device_cond: more than {MAX_DEPTH} nested conditions")
        lib = cuda_build.load_library()
        body = self.streams[depth]
        start = launch_counters()
        cuda_build.check(lib.tinyslam_graph_if_begin(
            torch.cuda.current_stream(self.device).cuda_stream, pred.data_ptr(), int(negate),
            body.cuda_stream), "tinyslam_graph_if_begin")
        self._nested.append([0] * len(start))
        try:
            with torch.cuda.stream(body), self.span(name):
                out = make()
                if name is not None:
                    i = self.slots[name]
                    self.tally[i:i + 1].add_(1)
        except BaseException:
            lib.tinyslam_graph_if_end(body.cuda_stream)     # the first error stands
            raise
        cuda_build.check(lib.tinyslam_graph_if_end(body.cuda_stream), "tinyslam_graph_if_end")
        inner = self._nested.pop()
        total = [b - a for a, b in zip(start, launch_counters())]
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

    def span(self, name: str):
        if self.stamps is None:
            return contextlib.nullcontext()
        return self.stamps.span(name)

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

    def loop(self, iters: int, step: Callable, carry):
        """A WHILE node that runs one turn's capture ``iters`` times: the
        carry lives in buffers that the body rewrites, the turn's y goes to
        row ``turn`` of the ys, and the body's last launch sets the
        condition for the next turn."""
        from tinyslam_tpu_torch.ops import cuda_build

        if self._nested or self._looping:
            raise ValueError("device_loop: a loop inside a conditional body or a loop")
        lib = cuda_build.load_library()
        outer, body = torch.cuda.current_stream(self.device), self.streams[0]
        state = [x.clone() for x in tree_leaves(carry)]
        turn = torch.zeros((), dtype=torch.int64, device=self.device)
        self.turns.append(turn)
        more = torch.full((), iters > 0, dtype=torch.bool, device=self.device)
        handle = ctypes.c_ulonglong(0)
        start = launch_counters()
        cuda_build.check(lib.tinyslam_graph_while_begin(
            outer.cuda_stream, more.data_ptr(), body.cuda_stream, ctypes.addressof(handle)),
            "tinyslam_graph_while_begin")
        self._looping = True
        try:
            with torch.cuda.stream(body):
                new, y = step(_rebuild(carry, iter(state)))
                new = tree_leaves(new)
                _same_form(state, new)
                # Taken from the outer stream's blocks: a block freed on the
                # body's stream is one the next turn's temporaries reuse.
                with torch.cuda.stream(outer):
                    ys = torch.empty((iters, *y.shape), dtype=y.dtype, device=self.device)
                ys.index_copy_(0, turn[None], y[None])
                for dst, src in zip(state, new):
                    dst.copy_(src)
                turn.add_(1)
                torch.lt(turn, iters, out=more)
        except BaseException:
            lib.tinyslam_graph_if_end(body.cuda_stream)     # the first error stands
            raise
        finally:
            self._looping = False
        cuda_build.check(lib.tinyslam_graph_while_end(body.cuda_stream, handle.value,
                                                      more.data_ptr()),
                         "tinyslam_graph_while_end")
        turn_launches = [b - a for a, b in zip(start, launch_counters())]
        self.in_loops = [x + (iters - 1) * t for x, t in zip(self.in_loops, turn_launches)]
        return _rebuild(carry, iter(state)), ys


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
    ``base`` those of a replay outside every branch's body (a loop's body
    counted once a turn), ``body_launches[name]`` those of a named branch
    (one set each time it runs), and ``turns``: each loop's turn counter,
    on the device, as the last replay left it; ``stamps`` (a
    ``spans.Stamps``, None for a capture without names or sites): each
    replay's span and ``tally_ns``, the nanoseconds of each named body and
    site."""

    graph: torch.cuda.CUDAGraph
    outputs: object
    names: tuple
    tally: torch.Tensor
    base: tuple
    body_launches: dict
    capture_s: float
    instantiate_s: float
    pool_bytes: int
    turns: tuple = ()
    stamps: spans.Stamps | None = None


def capture(fn: Callable, device, names: tuple, pool=None, sites: tuple = ()) -> Captured:
    """Capture ``fn()`` (on a side stream, after a synchronize of the
    whole device; hold ``CAPTURE_LOCK``) into a CUDA graph whose
    ``device_cond``s are conditional nodes, and instantiate it.  Where
    ``names`` or ``sites`` name a span, the graph's first and last nodes
    stamp each replay's span, and each named body and each ``device_span``
    of ``sites`` adds its nanoseconds to its slot of ``stamps.tally_ns``
    (``names`` first, then ``sites``); the card's timer is calibrated
    against the host's clock first (``spans.calibrate``).  Without a name
    the graph holds no stamp and ``stamps`` is None.
    The capture advances the kernels' launch counters once for every body;
    the caller restores them (``counters_kept``).
    ``pool`` is the memory pool of the graph's allocations
    (``torch.cuda.graph_pool_handle()``; a new one if None):
    graphs may share one only where they never run at the same time and
    each one's outputs are read before another of them replays.  Raises
    where the capture fails: the caller never falls back to running ``fn``
    eagerly."""
    dev = indexed_device(device)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    pool = torch.cuda.graph_pool_handle() if pool is None else pool
    rec = _Recorder(tuple(names), dev, tuple(sites))
    stream = _graph_streams(dev)[0]
    torch.cuda.synchronize(dev)
    if rec.stamps is not None:
        spans.calibrate(dev)
    reserved = torch.cuda.memory_reserved(dev)
    start = launch_counters()
    t0 = time.perf_counter()
    token = _MODE.set(rec)
    try:
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                _route_thread_to_pool(dev.index, pool)
                if rec.stamps is not None:
                    rec.stamps.step_begin()
                outputs = fn()
                if rec.stamps is not None:
                    rec.stamps.step_end()
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
    base = tuple(b - a - i + w for a, b, i, w in zip(start, launch_counters(), rec.in_bodies,
                                                      rec.in_loops))
    return Captured(graph=graph, outputs=outputs, names=tuple(names), tally=rec.tally,
                    base=base, body_launches=dict(rec.body_launches), capture_s=t1 - t0,
                    instantiate_s=t2 - t1,
                    pool_bytes=torch.cuda.memory_reserved(dev) - reserved,
                    turns=tuple(rec.turns), stamps=rec.stamps)


class Program:
    """``fn(static)`` on the card as one captured CUDA graph with no
    conditional node: the counterpart of one jitted dispatch of the JAX
    package.  ``example`` (a tree of tensors as ``tree_leaves`` reads it)
    gives the static input buffers their shapes and dtypes; each call
    copies its inputs into them without blocking (host tensors through
    pinned memory), replays once and returns the graph's outputs, which
    the next replay rewrites: the caller reads them back at once.

    Built by warming ``fn`` twice, the second time with any sync an error
    (``warm_checked``), then capturing it into ``pool`` (see ``capture``).
    A failed capture raises; nothing falls back to running ``fn`` eagerly.
    A replay makes no Python call, so each adds the launches the capture
    counted (``base``) to the kernels' counters.  ``example``'s values are
    what the warm-up runs on.
    """

    def __init__(self, fn: Callable, example, device, pool=None):
        dev = indexed_device(device)
        if dev.type != "cuda":
            raise ValueError(f"Program: a device {dev}; a captured program runs on the card")
        self.device = dev
        self.static = _rebuild(example, iter([x.to(dev).clone() for x in tree_leaves(example)]))
        with CAPTURE_LOCK, counters_kept():
            warm_checked(lambda: fn(self.static), dev)
            self.captured = capture(lambda: fn(self.static), dev, (), pool=pool)
        self.outputs = self.captured.outputs
        self.replays = 0

    def load(self, inputs) -> None:
        """Copy ``inputs`` (``example``'s structure) into the static
        buffers without blocking."""
        leaves = tree_leaves(inputs)
        static = tree_leaves(self.static)
        if len(leaves) != len(static):
            raise ValueError(f"Program: {len(leaves)} inputs for {len(static)} buffers")
        for dst, src in zip(static, leaves):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"Program: an input {tuple(src.shape)} {src.dtype} for a "
                                 f"buffer {tuple(dst.shape)} {dst.dtype}")
            if src.device.type == "cpu" and not src.is_pinned():
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)

    def __call__(self, inputs):
        """The outputs of ``fn`` on ``inputs``: one load, one replay on the
        current stream."""
        self.load(inputs)
        self.captured.graph.replay()
        self.replays += 1
        add_launches(self.captured.base)
        return self.outputs
