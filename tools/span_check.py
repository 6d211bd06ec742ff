#!/usr/bin/env python3
"""What the span recorder (``tinyslam_tpu_torch/utils/spans.py``) costs and
how well its clock agrees with the profiler's, on the card, at the
benchmark's ``mh01_fleet8`` cell (8 streams of 752x480, 16-step chunks):

    python tools/span_check.py [--seed 3600000001] [--seconds 8] [--profiles 3]

1. the cell's set-up and a window of ``--seconds`` through the captured
   step, as the benchmark's traced run has it; the new per-layer metrics
   as the benchmark's readers give them (``slambench/metrics/``), the
   harvest's time, the calibration's error, the stamps a step runs and
   the card timer's step (the gcd of the replays' spans);
2. a stamp node's device time: a captured chain of 500 small kernels with
   and without a span around each, replayed between CUDA events;
3. the recorder's host time a chunk: a chunk record opened, advanced and
   closed with the batched graph's stamps, 2,000 times;
4. last (a profiler session slows every later graph launch of the
   process): one single-step chunk under ``torch.profiler``, the ``k1``
   span's stamps on the host's clock against the profiler's K1 kernel,
   and the chunk's host spans among its host ranges.

Prints one JSON object.  Runs on the card only; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _graph_ms(fn, dev, reps: int = 20) -> tuple[float, object]:
    from tinyslam_tpu_torch.utils import cuda_graph

    with cuda_graph.CAPTURE_LOCK, cuda_graph.counters_kept():
        cuda_graph.warm_checked(fn, dev, sites=("s",))
        captured = cuda_graph.capture(fn, dev, (), sites=("s",))
    captured.graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        captured.graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, captured


def stamp_node_ns(dev, k: int = 500) -> dict:
    """Device ns a stamp node adds to a chain of small dependent kernels."""
    from tinyslam_tpu_torch.utils.cuda_graph import device_span

    x = torch.zeros(256, device=dev)

    def plain():
        for _ in range(k):
            x.add_(1.0)

    def stamped():
        for _ in range(k):
            with device_span("s"):
                x.add_(1.0)

    ms_plain, _ = _graph_ms(plain, dev)
    ms_stamped, captured = _graph_ms(stamped, dev)
    assert int(captured.stamps.tally_ns[0]) > 0
    return {"chain_kernels": k, "plain_ms": ms_plain, "stamped_ms": ms_stamped,
            "ns_per_stamp_node": (ms_stamped - ms_plain) * 1e6 / (2 * k)}


def recorder_host_us(graph, n: int = 2000) -> float:
    from tinyslam_tpu_torch.utils import spans

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rec = spans.Chunk("batch", 16)
        rec.loaded()
        rec.launched()
        rec.close(graph.captured, 16)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


READERS = ("fleet.graph_ms_per_step", "fleet.card_ms_per_step", "fleet.keyframe_ms_per_step",
           "fleet.keyframes_per_kframe", "fleet.relocs_per_kframe", "device.graph_idle_share",
           "device.idle_share", "fleet.caller_ms_per_chunk")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3600000001)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--profiles", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("span_check: needs the card")
    torch.set_num_threads(1)
    from slambench import chunks, harness
    from tinyslam_tpu_torch.models.vo_device import BATCH_BRANCHES, _BATCH_GRAPHS
    from tinyslam_tpu_torch.utils import spans

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"device": torch.cuda.get_device_name(dev), "torch": torch.__version__,
           "cuda": torch.version.cuda, "seed": args.seed}
    harness.pin_caches()
    spans.reset()
    w = harness.load_json("workloads", "mh01_fleet8")
    c = harness.load_json("configs", w["config"])
    run = harness.Run(w, c, args.seed, args.seconds, True, dev)
    t0 = time.perf_counter()
    cell = harness.load_module("traffic", w["traffic"]).Cell(run)
    out["setup_s"] = time.perf_counter() - t0
    graph = next(iter(_BATCH_GRAPHS.values()))
    rec = cell.window(args.seconds)

    # 1. the readers, the harvest, calibration, stamps a step, the timer's step
    t0 = time.perf_counter()
    spans.records()
    out["harvest_ms"] = (time.perf_counter() - t0) * 1e3
    out["metrics"] = {n: harness.load_module("metrics", n).read(rec) for n in READERS}
    out["calibrations"] = [list(p) for p in spans._CALIBRATIONS[dev.index]]
    win = chunks.window(rec)
    replays = chunks.replays(win)
    runs = {n: chunks.delta(win, "tally", n) for n in BATCH_BRANCHES}
    out["replays"] = replays
    out["body_runs"] = runs
    # step: 2, k1: 2, k2.track: 2 a launch (the guided pass, and the second
    # pass where it runs), each body run: 2
    out["stamp_nodes_per_step"] = (4 + 2 * (replays + runs["second_pass"]) / replays
                                   + 2 * sum(runs.values()) / replays)
    out["recorded_host_us_per_chunk_call"] = float(np.mean(
        [(r["host_ns"]["exit"] - r["host_ns"]["entry"]) / 1e3 for r in win[1:]]))
    st = graph.captured.stamps
    S = len(st.names)
    pairs = st.buf[S + 1:S + 1 + 2 * spans.STEP_CAP].cpu().numpy().reshape(-1, 2)
    out["timer_step_ns"] = int(np.gcd.reduce((pairs[:, 1] - pairs[:, 0])[pairs[:, 0] > 0]))
    out["tally_ns_ms"] = {n: chunks.delta(win, "tally_ns", n) / 1e6 for n in st.names}

    # 2. a stamp node's device time
    out["stamp_cost"] = stamp_node_ns(dev)
    out["stamp_cost"]["per_step_us"] = (out["stamp_cost"]["ns_per_stamp_node"]
                                        * out["stamp_nodes_per_step"] / 1e3)
    out["stamp_cost"]["share_of_step_pct"] = (100 * out["stamp_cost"]["per_step_us"] / 1e3
                                              / out["metrics"]["fleet.graph_ms_per_step"])

    # 3. the recorder's host time a chunk
    out["recorder_host_us_per_chunk"] = recorder_host_us(graph)
    spans.reset()

    # 4. the profiler's clock against the stamps'
    out["profiler_alignment"] = [profiler_alignment(cell, st, dev)
                                 for _ in range(args.profiles)]
    print(json.dumps(out))


def profiler_alignment(cell, st, dev) -> dict:
    """One single-step chunk of the fleet's batched graph under
    ``torch.profiler``: the ``k1`` span's stamps on the host's clock
    against the profiler's K1 kernel, the record's host times against the
    profiler's ranges of the same spans, and the graph launch's host call
    (the replay's work cannot start before it)."""
    from torch.profiler import ProfilerActivity, profile

    from tinyslam_tpu_torch.models.vo_device import track_chunk_batch
    from tinyslam_tpu_torch.utils import spans

    idx = (np.asarray(cell.offsets)[:, None] + cell.next + np.arange(1)) % len(cell.frames)
    cell.next += 1
    images = torch.from_numpy(cell.frames[idx]).to(dev)
    active = np.ones((cell.B, 1), dtype=bool)
    cell.states, _ = track_chunk_batch(cell.cam, cell.cfg, cell.states, images, active,
                                       cell.samplers)
    torch.cuda.synchronize()
    before_ns = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cell.states, _ = track_chunk_batch(cell.cam, cell.cfg, cell.states, images, active,
                                           cell.samplers)
        torch.cuda.synchronize()
    recs = spans.records()
    prev, cur = recs[-2]["device"], recs[-1]["device"]
    to_host = spans.host_clock(spans._CALIBRATIONS[dev.index])
    k1_begin, err = to_host(int(st.buf[st._begins + st.slots["k1"]]))
    k1_end = k1_begin + cur["tally_ns"]["k1"] - prev["tally_ns"]["k1"]
    base = prof.profiler.kineto_results.trace_start_ns()
    events = []
    for e in prof.profiler.kineto_results.events():
        t = e.start_ns()
        if abs(t - before_ns) > 10**12:            # relative to the trace's start
            t += base
        events.append((e.name(), t, t + e.duration_ns(),
                       e.device_type() == torch.autograd.DeviceType.CUDA))
    host = [e for e in events if not e[3]]
    times = [recs[-1]["host_ns"][k] for k in spans.HOST_TIMES]
    align = {"error_ns": err, "k1_stamp_ns": [k1_begin, k1_end],
             # each host span's range against the record's times around it
             "host_span_offsets_ns": {name: [e[1] - times[i], e[2] - times[i + 1]]
                                      for i, name in enumerate(spans.HOST_SPANS)
                                      for e in host if e[0] == name}}
    kern = [e for e in events if e[3] and "fast_pyramid_kernel" in e[0]]
    launches = [e for e in host if e[0] == "cudaGraphLaunch"]
    if kern:
        _, ks, ke, _ = kern[-1]
        rb, re_ = cur["replay_ns"][-1]
        align.update({"k1_kernel_ns": [ks, ke], "start_offset_ns": ks - k1_begin,
                      "end_offset_ns": k1_end - ke,
                      "within_error_plus_5us": bool(abs(ks - k1_begin) <= err + 5000
                                                    and abs(k1_end - ke) <= err + 5000),
                      "replay_ns": [rb, re_],
                      "kernel_inside_replay": bool(rb - err <= ks and ke <= re_ + err)})
        if launches:
            align["kernel_start_after_launch_ns"] = ks - launches[-1][1]
            align["replay_start_after_launch_ns"] = rb - launches[-1][1]
    return align


if __name__ == "__main__":
    main()
