"""What a captured graph's conditional nodes and launches cost on the card,
and what the batched tracker's warm-up does to a later loop capture.

    python tools/batch_graph_probe.py if-pairs
    python tools/batch_graph_probe.py launches
    python tools/batch_graph_probe.py while-after-warm potrs|triangular

``if-pairs``: card and host ms of one replay of a graph of K untaken
``device_cond`` pairs whose bodies hold N elementwise kernels each.
``launches``: the batched graph at B = 8 on the bench orbit (8 streams of
24 frames): frames/s of its chunk and ms a raw replay (enqueue, and done
after a synchronize), before and after one ``torch.profiler`` session in
the process.  ``while-after-warm``: the batched step warmed on the graph
body streams at B = 3 (160x120, ``tests/torch_parity``'s set-up), then a
``device_loop`` of a Cholesky step captured, solving with ``cholesky_solve``
(cuSOLVER's ``potrs``) or with two ``solve_triangular``s; prints whether
the capture instantiates.  Each mode runs in a process of its own; run
them on the card from the repository root.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def _replay_ms(replay, reps: int = 10) -> tuple[float, float]:
    """Median host ms to enqueue one replay, median card ms of one."""
    host, card = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        replay()
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        torch.cuda.synchronize()
        card.append(start.elapsed_time(end))
    return float(np.median(host)), float(np.median(card))


def if_pairs(smi: str) -> None:
    from tinyslam_tpu_torch.utils.cuda_graph import (
        CAPTURE_LOCK, capture, counters_kept, device_cond, warm_checked,
    )

    dev = torch.device("cuda")
    x = torch.zeros(1024, device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    for pairs, kernels in ((0, 0), (1, 10), (16, 10), (16, 300), (64, 300)):
        def body(v, kernels=kernels):
            for _ in range(kernels):
                v = v * 1.0001 + 1.0
            return v

        def fn(pairs=pairs, body=body):
            out = x
            for _ in range(pairs):
                out = device_cond(pred, body, lambda v: v, (out,))
            return out + 1.0

        with CAPTURE_LOCK, counters_kept():
            warm_checked(fn, dev)
            captured = capture(fn, dev, ())
        host, card = _replay_ms(captured.graph.replay)
        print(f"if-pairs: {pairs} untaken pairs of {kernels} kernels: a replay {card:.3f} ms on "
              f"the card, {host:.3f} ms to enqueue  [{smi}]", flush=True)


def launches(smi: str) -> None:
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from tinyslam_tpu_torch import SlamConfig, eval_ate
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.models.vo_device import VOState
    from tinyslam_tpu_torch.utils.draws import Sampler

    dev = torch.device("cuda")
    room, cam, poses = cs._orbit()
    frames = eval_ate.render_clean(cs._orbit_scene, (), 166)
    cfg = SlamConfig()
    thr = torch.tensor(cfg.frontend.threshold, device=dev)
    starts = list(range(0, 160, 20))
    seeds = [cs._seeded(cfg, extract_features(torch.from_numpy(frames[s0]).to(dev), thr,
                                              cfg.frontend), room, cam, poses[s0])
             for s0 in starts]
    images = torch.from_numpy(np.stack([np.stack(frames[s0 + 1:s0 + 25])
                                        for s0 in starts])).to(dev)
    active = np.ones((len(starts), 24), bool)
    samplers = [Sampler(b) for b in range(len(starts))]
    graph = vd.batch_graph(cam, cfg, VOState.stack(seeds), images[:, 0], samplers)

    def report(label: str) -> None:
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vd.track_chunk_batch(cam, cfg, VOState.stack(seeds), images, active, samplers)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(24):
            graph.captured.graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"launches {label}: B=8 chunk {[round(active.size / s, 1) for s in secs]} "
              f"frames/s; 24 raw replays: enqueue {1e3 * (t1 - t0) / 24:.2f} ms, done "
              f"{1e3 * (t2 - t0) / 24:.2f} ms a replay  [{smi}]", flush=True)

    report("before any profiler")
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(4, device=dev).sum().item()
    report("after one profiler session")


def while_after_warm(solver: str, smi: str) -> None:
    import torch_parity as P

    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.models.vo_device import VOState
    from tinyslam_tpu_torch.utils.cuda_graph import Program, device_loop, warm_checked
    from tinyslam_tpu_torch.utils.draws import Sampler

    dev = torch.device("cuda")
    cfg = P.torch_config(keyframes=True)
    frames, poses, room = P.orbit(max(P.MULTI_STARTS) + P.MULTI_FRAMES + 1)

    def features_of(frame):
        return extract_features(torch.from_numpy(frame), cfg.frontend.threshold,
                                cfg.frontend).to_numpy()

    seeds, images, _ = P.multi_sequences(frames, poses, room, features_of, cfg)
    cam = PinholeCamera.create(**P.CAMERA)
    states = VOState.stack([VOState.from_numpy(s, dev) for s in seeds])
    first = torch.from_numpy(images[:, 0]).to(dev)
    flags = torch.ones(len(seeds), dtype=torch.bool, device=dev)
    samplers = [Sampler(b) for b in range(len(seeds))]
    warm_checked(lambda: vd._step_batch(cam, cfg, vd._tree_map(torch.clone, states), first,
                                        flags, samplers), dev)

    n = 192
    rng = np.random.default_rng(0)
    a = rng.normal(size=(n, n)).astype(np.float32)
    example = {"H": torch.from_numpy(a @ a.T + n * np.eye(n, dtype=np.float32)),
               "g": torch.from_numpy(rng.normal(size=n).astype(np.float32))}

    def fn(s):
        def step(x):
            L, _ = torch.linalg.cholesky_ex(s["H"])
            rhs = (s["g"] + x)[:, None]
            if solver == "potrs":
                dx = torch.cholesky_solve(rhs, L)[:, 0]
            else:
                y = torch.linalg.solve_triangular(L, rhs, upper=False)
                dx = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
            return x + 0.5 * dx, dx.sum()
        return device_loop(5, step, torch.zeros_like(s["g"]))[0]

    try:
        Program(fn, example, dev)
        torch.cuda.synchronize()
        print(f"while-after-warm {solver}: the loop's capture instantiated  [{smi}]")
    except RuntimeError as exc:
        print(f"while-after-warm {solver}: the capture failed: "
              f"{type(exc).__name__}: {str(exc).splitlines()[0]}  [{smi}]")


def main() -> None:
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("batch_graph_probe: needs the card")
    smi = cs._smi()
    mode = sys.argv[1]
    if mode == "if-pairs":
        if_pairs(smi)
    elif mode == "launches":
        launches(smi)
    elif mode == "while-after-warm":
        while_after_warm(sys.argv[2], smi)
    else:
        raise SystemExit(f"batch_graph_probe: no mode {mode!r}")


if __name__ == "__main__":
    main()
