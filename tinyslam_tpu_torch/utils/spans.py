"""Spans and counters of the tracker's captured steps and of its chunks,
on the host's clock.

**Device spans.**  Every step captured by ``utils/cuda_graph.py:capture``
with named bodies or sites holds one-thread stamp kernels (``csrc/stamp.cu``) that read the card's
nanosecond timer, ``%globaltimer``, where they run, into the capture's
``Stamps`` buffer on the card:

- the step's first and last node: each replay's span, the last
  ``STEP_CAP`` replays' kept beside a replay counter;
- a pair around each named branch body, beside the body's tally: the
  nanoseconds the body ran, added to its slot of ``tally_ns`` (int64,
  cumulative; a nested body counts in its parent's too, so ``keyframe``
  holds its ``ba``);
- a pair around each site marked by ``cuda_graph.device_span(name)`` where
  the capture has a slot ``name``: K1 in ``extract_batch`` (``k1``), K2 in
  the batched tracker's guided pass and second pass (``k2.track``).

A stamp adds no synchronization.  Outside a capture, stamps run only
inside ``cuda_graph.warm`` given the capture's names (into a scratch
buffer, so that the warm-up runs them as the capture will); an eager step
has none, nor has a capture without names (a SLAM ``Program``).

**Chunk records.**  Each chunk of the tracker (``ChunkGraph.track_chunk``,
``BatchGraph.track_chunk``, ``track_chunk_batch``'s plain path) keeps one
record (``Chunk``): a process-wide sequence number, the id that the
chunk's spans share, and four host times on ``time.time_ns()``
(CLOCK_REALTIME, the clock of ``torch.profiler``'s host events): its
entry, its inputs loaded (the first replay about to launch), its last
replay and that replay's result copies queued, and its exit.  A captured
chunk also copies, without blocking, its replays' spans and the capture's
cumulative ``tally`` and ``tally_ns`` as its last replay left them into
its slot of a pinned ring on the host.  The last ``CAPACITY`` chunks are
kept.  While a ``torch.profiler`` session records, the spans between the
host times also show in its trace, as ``record_function`` ranges named
as in ``HOST_SPANS``.

**Harvest.**  ``records()`` synchronizes once and returns the kept chunks,
their device spans on the host's clock.  The card's timer is mapped onto
the host's by calibrations (``calibrate``): a stamp bracketed by two host
readings, the narrowest bracket of several kept, taken at each capture and
at each harvest.  Between two calibrations the map is linear; each record
carries the larger half-width of the two brackets as its error.

Recording is always on: a captured graph holds its stamp nodes or not,
and a switch would need a second capture.  Nothing is read back until a
harvest.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import itertools
import time

import numpy as np
import torch

CAPACITY = 4096         # chunk records kept
STEP_CAP = 64           # replay spans a capture keeps on the card
MAX_SLOTS = 16          # named spans (bodies and sites) of one capture
HOST_TIMES = ("entry", "loaded", "launched", "exit")
HOST_SPANS = ("chunk.load", "chunk.replays", "chunk.finish")    # between the host times
_WIDTH = MAX_SLOTS + 1 + 2 * STEP_CAP

_SERIAL = itertools.count()
_SEQ = itertools.count()
_RECORDS: collections.deque = collections.deque(maxlen=CAPACITY)
_PINNED: dict = {}          # device -> (int64 (CAPACITY, _WIDTH), int32 (CAPACITY, MAX_SLOTS))
_CALIBRATIONS: dict = {}    # device index -> [(card ns, host ns, error ns)]


def _launch(entry: str, *args) -> None:
    """One stamp kernel on the current stream."""
    from tinyslam_tpu_torch.ops import cuda_build

    err = getattr(cuda_build.load_library(), entry)(*args,
                                                    torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, entry)


class Stamps:
    """The stamp buffer of one capture on the card, int64, its spans named
    by ``names``, laid out as:

    - ``[0, S)``: ``tally_ns``, each span's nanoseconds, cumulative;
    - ``[S]``: the replays counted by the step's last stamp;
    - ``[S + 1, S + 1 + 2 STEP_CAP)``: replay r's (begin, end) at pair
      ``r % STEP_CAP``;
    - then each span's last begin, and the running replay's begin.

    A chunk copies the first ``record_len`` words to the host."""

    def __init__(self, names: tuple, device):
        if len(names) > MAX_SLOTS:
            raise ValueError(f"Stamps: {len(names)} spans, more than {MAX_SLOTS}")
        self.names = tuple(names)
        self.slots = {name: i for i, name in enumerate(self.names)}
        self.serial = next(_SERIAL)
        S = len(self.names)
        self.record_len = S + 1 + 2 * STEP_CAP
        self.buf = torch.zeros(self.record_len + S + 1, dtype=torch.int64, device=device)
        self._begins = self.record_len
        self._step = self.record_len + S

    @property
    def tally_ns(self) -> torch.Tensor:
        return self.buf[:len(self.names)]

    def _at(self, i: int) -> int:
        return self.buf.data_ptr() + 8 * i

    def begin(self, name: str) -> None:
        _launch("tinyslam_stamp_mark", self._at(self._begins + self.slots[name]))

    def end(self, name: str) -> None:
        i = self.slots[name]
        _launch("tinyslam_stamp_add", self._at(self._begins + i), self._at(i))

    @contextlib.contextmanager
    def span(self, name):
        """Stamp the work launched inside the ``with`` as span ``name``;
        nothing for a name (or None) that has no slot."""
        if name not in self.slots:
            yield
            return
        self.begin(name)
        yield
        self.end(name)

    def step_begin(self) -> None:
        _launch("tinyslam_stamp_mark", self._at(self._step))

    def step_end(self) -> None:
        _launch("tinyslam_stamp_step", self._at(self._step), self._at(len(self.names)),
                STEP_CAP)


def _pinned(device: torch.device) -> tuple:
    if device not in _PINNED:
        _PINNED[device] = (torch.zeros((CAPACITY, _WIDTH), dtype=torch.int64, pin_memory=True),
                           torch.zeros((CAPACITY, MAX_SLOTS), dtype=torch.int32,
                                       pin_memory=True))
    return _PINNED[device]


class Chunk:
    """One chunk's record, opened at the tracker's entry; ``loaded()`` once
    its inputs are in place, ``launched()`` once its replays are queued,
    ``close()`` at its exit."""

    __slots__ = ("seq", "kind", "steps", "replays", "host_ns", "stamps", "names", "_range")

    def __init__(self, kind: str, steps: int):
        self.host_ns = [time.time_ns(), 0, 0, 0]
        self.seq = next(_SEQ)
        self.kind = kind
        self.steps = int(steps)
        self.replays = 0
        self.stamps = None
        self.names = ()
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._next_range(0)

    def _next_range(self, i: int) -> None:
        from torch.autograd.profiler import record_function

        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._range = None
        if i < len(HOST_SPANS):
            self._range = record_function(HOST_SPANS[i])
            self._range.__enter__()

    def loaded(self) -> None:
        self.host_ns[1] = time.time_ns()
        if self._range is not None:
            self._next_range(1)

    def launched(self) -> None:
        self.host_ns[2] = time.time_ns()
        if self._range is not None:
            self._next_range(2)

    def close(self, captured=None, replays: int = 0) -> None:
        """End the record; ``captured`` (a ``cuda_graph.Captured``) and its
        ``replays`` this chunk for a chunk replayed on the card."""
        self.replays = int(replays)
        if captured is not None and captured.stamps is not None:
            st = self.stamps = captured.stamps
            self.names = captured.names
            ring, tallies = _pinned(st.buf.device)
            slot = self.seq % CAPACITY
            ring[slot, :st.record_len].copy_(st.buf[:st.record_len], non_blocking=True)
            tallies[slot, :len(self.names)].copy_(captured.tally, non_blocking=True)
        self.host_ns[3] = time.time_ns()
        if self._range is not None:
            self._next_range(len(HOST_SPANS))
        _RECORDS.append(self)

    def as_dict(self) -> dict:
        out = {"seq": self.seq, "kind": self.kind, "steps": self.steps,
               "replays": self.replays, "host_ns": dict(zip(HOST_TIMES, self.host_ns)),
               "device": None}
        st = self.stamps
        if st is not None:
            ring, tallies = _pinned(st.buf.device)
            slot = self.seq % CAPACITY
            out["device"] = parse(ring[slot].numpy(), tallies[slot].numpy(), self.names,
                                  st.names, self.replays,
                                  host_clock(_CALIBRATIONS.get(st.buf.device.index, [])))
            if out["device"] is not None:
                out["device"]["graph"] = st.serial
        return out


def parse(row: np.ndarray, tally_row: np.ndarray, names: tuple, spans: tuple, replays: int,
          to_host) -> dict | None:
    """A captured chunk's device part from its slot of the pinned ring:
    ``row`` (a ``Stamps`` record: ``tally_ns`` of ``spans``, the replay
    counter, the replay spans), ``tally_row`` (the tally of ``names``),
    the chunk's ``replays``; stamps mapped by ``to_host`` (``host_clock``).
    None where the ring on the card no longer held all its replays."""
    S = len(spans)
    count = int(row[S])
    if replays > STEP_CAP or count < replays or not callable(to_host):
        return None
    pairs = row[S + 1:S + 1 + 2 * STEP_CAP].reshape(STEP_CAP, 2)
    replay_ns, error = [], 0
    for r in range(count - replays, count):
        (b, eb), (e, ee) = (to_host(int(g)) for g in pairs[r % STEP_CAP])
        replay_ns.append([b, e])
        error = max(error, eb, ee)
    return {"replay_ns": replay_ns, "replays_total": count,
            "tally": {n: int(v) for n, v in zip(names, tally_row)},
            "tally_ns": {n: int(v) for n, v in zip(spans, row[:S])}, "error_ns": error}


def host_clock(points):
    """The map of card nanoseconds onto the host's, from calibration
    ``points`` [(card ns, host ns, error ns)]: linear between neighbouring
    points, the nearest point's offset outside them.  Returns ``g ->
    (host ns, error ns)``, or None without a point.  Integer arithmetic:
    nanoseconds since 1970 do not fit a float's mantissa."""
    pts = sorted(points)
    if not pts:
        return None
    keys = [p[0] for p in pts]

    def to_host(g: int) -> tuple[int, int]:
        i = bisect.bisect_right(keys, g) - 1
        if i < 0 or i >= len(pts) - 1:
            g0, h0, e0 = pts[max(i, 0)]
            return h0 + (g - g0), e0
        (g0, h0, e0), (g1, h1, e1) = pts[i], pts[i + 1]
        return h0 + round((g - g0) * (h1 - h0) / (g1 - g0)), max(e0, e1)

    return to_host


def calibrate(device, trials: int = 16) -> tuple[int, int, int]:
    """Calibrate the card's timer against ``time.time_ns()``: ``trials``
    stamps, each bracketed by two host readings, the narrowest kept as a
    point (card ns, host ns at the bracket's middle, its half-width).
    Launches on ``device``'s current stream, which must be idle."""
    from tinyslam_tpu_torch.ops import cuda_build

    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(dev):
        err = cuda_build.load_library().tinyslam_stamp_calibrate(
            torch.cuda.current_stream(dev).cuda_stream, trials, ctypes.addressof(out))
    cuda_build.check(err, "tinyslam_stamp_calibrate")
    g, before, after = (int(x) for x in out)
    point = (g, (before + after) // 2, (after - before + 1) // 2)
    _CALIBRATIONS.setdefault(dev.index, []).append(point)
    return point


def records() -> list[dict]:
    """The kept chunk records, oldest first, as dicts: ``seq``, ``kind``
    (``"batch"``, ``"chunk"`` or ``"plain"``), ``steps``, ``replays``,
    ``host_ns`` (``HOST_TIMES``) and ``device``: None for a chunk that ran
    no captured step, else {``graph`` (the capture's serial number),
    ``replay_ns`` (each replay's [begin, end] on the host's clock),
    ``replays_total`` (the capture's replays so far), ``tally`` and
    ``tally_ns`` by name (cumulative, as the chunk's last replay left
    them), ``error_ns`` (the clock map's error bound)}.  Synchronizes each
    card that holds a record once and calibrates it."""
    for dev in {r.stamps.buf.device for r in _RECORDS if r.stamps is not None}:
        torch.cuda.synchronize(dev)
        calibrate(dev)
    return [r.as_dict() for r in list(_RECORDS)]


def reset() -> None:
    """Forget the kept records and start the sequence at 0 again."""
    global _SEQ
    _RECORDS.clear()
    _SEQ = itertools.count()
