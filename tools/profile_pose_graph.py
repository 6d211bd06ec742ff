"""Where a pose-graph solve's time goes on the card.

    python tools/profile_pose_graph.py [--nodes 11] [--device cuda] [--root DIR]

Builds a Sim(3) keyframe chain of ``--nodes`` poses on an arc (odometry
edges with 1 cm of noise) and one loop edge at scale 1.3, as phase 9 of
``chip_smoke.py`` solves it, and runs ``models/slam.py:solve_graph`` under
the default ``SlamConfig()`` (padded to 32 nodes and 128 edges, 20
Gauss-Newton iterations).  Prints the wall time of the process's first
solve and of three warm ones, the device time and kernel launches of one
warm solve from ``torch.profiler``, and the operators that take the most
host time.  On the card it also times the order-fixed assembly kernel
(``ops/scatter_cuda.py``) on the solve's first Gauss-Newton iteration's
terms, from launches queued between CUDA events, beside one
``index_add_`` of the same terms (atomics), with the longest segment (the
gauge node's slots).  ``--root`` imports ``tinyslam_tpu_torch`` from
another tree (a parent commit unpacked with ``git archive``), to set its
solve beside this tree's in one call.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def snapshot(n: int, seed: int = 0):
    """(R (n, 3, 3), t (n, 3), edges) of a chain on a 1.5-turn arc."""
    import torch

    from tinyslam_tpu_torch.geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse

    rng = np.random.default_rng(seed)
    xi = np.zeros((n, 7), np.float32)
    ang = np.linspace(0, 1.5 * np.pi, n)
    xi[:, 0], xi[:, 2], xi[:, 4] = 2 * np.cos(ang), 2 * np.sin(ang), ang
    R, t, s = sim3_exp(torch.from_numpy(xi))
    edges = []
    for k in range(n - 1):
        Re, te, _ = sim3_compose(R[k + 1], t[k + 1], s[k + 1],
                                 *sim3_inverse(R[k], t[k], s[k]))
        edges.append((k, k + 1, Re.numpy(),
                      te.numpy() + rng.normal(0, 0.01, 3).astype(np.float32), 1.0, 1.0))
    edges.append((2, n - 1, edges[0][2], edges[0][3], 1.3, 2.0))
    return R.numpy(), t.numpy(), edges


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=11)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=None,
                    help="import tinyslam_tpu_torch from this tree")
    args = ap.parse_args()
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    import tinyslam_tpu_torch
    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.models.slam import solve_graph

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg, snap = SlamConfig(), snapshot(args.nodes)
    wall = []
    for _ in range(4):
        sync()
        t0 = time.perf_counter()
        solve_graph(cfg, snap, dev)
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        solve_graph(cfg, snap, dev)
        sync()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    device_us = 0.0
    if dev.type == "cuda":      # device time from a trace of the kernels alone
        with profile(activities=[ProfilerActivity.CUDA]) as dprof:
            solve_graph(cfg, snap, dev)
            sync()
        device_us = sum(e.self_device_time_total for e in dprof.key_averages())
    if dev.type == "cuda":
        from chip_smoke import _smi

        card = f"device {device_us / 1e3:.3f} ms, {launches} kernel launches  [{_smi()}]"
    else:
        card = "device time and launches not measured (no card)  [cpu]"
    print(f"solve_graph ({Path(tinyslam_tpu_torch.__file__).parents[1]}), {args.nodes} "
          f"nodes: wall ms first {wall[0]:.1f}, warm "
          f"{[round(w, 1) for w in wall[1:]]}; one warm solve: {card}")
    if dev.type == "cuda":
        print(assembly_line(cfg, snap, dev))
    print(ka.table(sort_by="cpu_time_total", row_limit=15))


def assembly_line(cfg, snap, dev) -> str:
    """The assembly kernel's and one ``index_add_``'s device time on the
    first Gauss-Newton iteration's terms of a solve of ``snap``."""
    import torch

    from chip_smoke import _FirstAssembly, _queued_ms, _smi
    from tinyslam_tpu_torch.models.slam import solve_graph

    with _FirstAssembly() as assembly:
        solve_graph(cfg, snap, dev)
    (plan, vals), kernel = assembly.first, assembly.real
    kernel_us = _queued_ms(lambda: kernel(plan, vals)) * 1e3
    library_us = _queued_ms(lambda: torch.zeros(plan.size, dtype=vals.dtype, device=dev)
                            .index_add_(0, plan.at, vals)) * 1e3
    longest = int((plan.ptr[1:] - plan.ptr[:-1]).max())
    return (f"assembly, first iteration: {vals.numel()} terms into {plan.size} slots, longest "
            f"segment {longest}; kernel {kernel_us:.2f} us, index_add_ {library_us:.2f} us, "
            f"kernel / index_add_ {kernel_us / library_us:.2f} (queued CUDA events)  [{_smi()}]")


if __name__ == "__main__":
    main()
