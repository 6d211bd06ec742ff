#!/usr/bin/env python3
"""When the asynchronous back-end's correction lands, on ``chip_smoke.py``
phase 9's out-and-back (``chip_smoke.slam_config()``, frames fed at once).

    python tools/async_timing.py

``DeviceSlam`` synchronous, then asynchronous through the captured graph
(waiting for a solve 16 frames old, the default, and never waiting) and on
the plain path: for each, when the closure's solve was submitted
(frame, seconds), ran on the worker and was applied, and the Sim(3)-aligned
ATE from the bootstrap frame.  Runs on the card only.  Imports nothing of
JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("async_timing: needs the card")
    import chip_smoke as cs
    from tinyslam_tpu_torch import eval_ate
    from tinyslam_tpu_torch.models.slam import DeviceSlam
    from tinyslam_tpu_torch.ops import cuda_build
    from tinyslam_tpu_torch.utils.draws import Sampler
    from tinyslam_tpu_torch.utils.evaluation import ate_rmse

    cuda_build.build()
    cuda_build.load_library()
    print(torch.cuda.get_device_name(0), "|", cs._smi())
    _, cam, poses = cs._orbit()
    frames = eval_ate.render_clean(cs._orbit_scene, (), cs.N_SLAM)
    seq = cs.out_and_back(cs.N_SLAM)
    images = [frames[i] for i in seq]
    gt = cs._centres([poses[i][0] for i in seq], [poses[i][1] for i in seq])

    def run(name, async_backend, graph=True, lag=16):
        slam = DeviceSlam(cs.slam_config(), cam, chunk=cs.CHUNK, async_backend=async_backend,
                          device="cuda", sampler=Sampler(0))
        slam.solve_lag_frames = lag
        slam.vo.graph = graph
        log, t0 = [], time.perf_counter()

        def logged(kind, fn):
            def call(*a):
                start = (kind, len(slam.vo.stats) + len(slam.vo._buf),
                         round(time.perf_counter() - t0, 3))
                out = fn(*a)
                log.append(start + (round(time.perf_counter() - t0, 3),))
                return out
            return call

        slam._optimize_graph = logged("submit", slam._optimize_graph)
        slam._solve_on_worker = logged("solve", slam._solve_on_worker)
        slam._apply_graph_result = logged("apply", slam._apply_graph_result)
        try:
            for im in images:
                slam.process_frame(im)
            slam.finalize()
            torch.cuda.synchronize()
        finally:
            slam.close()
        b0 = slam.vo.host_frames - 1
        print(f"{name}: {slam.num_loop_closures} closures, ATE "
              f"{ate_rmse(slam.positions[b0:], gt[b0:]):.4f}, {len(images)} frames in "
              f"{time.perf_counter() - t0:.2f} s; (event, frame, start s, end s) "
              f"{[e for e in log if e[0] != 'submit' or async_backend]}")

    run("synchronous, graph", False)
    run("asynchronous, graph", True)
    run("asynchronous, graph, never waiting", True, lag=None)
    run("asynchronous, plain path", True, graph=False)


if __name__ == "__main__":
    main()
