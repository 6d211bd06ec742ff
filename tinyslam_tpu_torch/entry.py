"""The port's entry points, the counterpart of the JAX package's
``__graft_entry__.py`` (it imports nothing of that file).

- ``entry(device="cuda")`` -> ``(fn, (state, image))``: one ``track_step``
  of the default ``SlamConfig()`` on a 640x480 frame, from a state whose map
  holds 256 seeded landmarks, with the same numpy draws as the JAX entry.
- ``dryrun_multichip(n, device="cuda")``: the multi-device pipeline over
  the port's mesh at n ranks on tiny shapes: frame-parallel ORB,
  landmark-sharded BA, the edge-sharded, node-sharded and Sim(3) pose
  graphs, and B sequences tracked under frame parallelism
  (``parallel/track_dp.py``; on the card through the captured
  ``BatchGraph``).  One process a rank; rank 0 prints one line with the
  JAX line's fields, the backend and the per-stage wall time, after a line
  that says which path stage 4 took.
  NCCL where the host has n cards; otherwise gloo ranks sharing the one
  card with CUDA tensors; gloo on the CPU only when ``device="cpu"``::

      python -m tinyslam_tpu_torch.entry --dryrun 2 [--device cpu]
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tinyslam_tpu_torch.entry: CUDA is not available; pass "
                           "device='cpu' for the CPU")
    return dev


def entry(device="cuda"):
    """(fn, (state, image)): ``fn(state, image)`` is one ``track_step`` (the
    flagship model's tracked frame: extraction, guided matching, PnP, and
    keyframe insertion with the window BA where the policy asks for one)
    under ``Sampler(0)``, on ``device``."""
    from tinyslam_tpu_torch.config import SlamConfig
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models.vo_device import VOState, track_step
    from tinyslam_tpu_torch.types import from_numpy
    from tinyslam_tpu_torch.utils.draws import Sampler

    dev = _device(device)
    cfg = SlamConfig()
    cam = PinholeCamera.create(fx=520.0, fy=520.0, cx=319.5, cy=239.5)
    sampler = Sampler(0)

    def fn(state, image):
        return track_step(cam, cfg, state, image, sampler)

    rng = np.random.default_rng(0)
    state = VOState.empty(cfg, dev)
    # Seed a few landmarks so the guided-matching path has work to do.
    n_seed = 256
    X = rng.normal(0.0, 1.0, (n_seed, 3)).astype(np.float32) + [0, 0, 4.0]
    desc = rng.integers(0, 2**32 - 1, (n_seed, 8), np.uint32)
    m = state.map
    X_all, valid, desc_all = m.X.clone(), m.valid.clone(), m.desc.clone()
    X_all[:n_seed] = from_numpy(X.astype(np.float32), dev)
    valid[:n_seed] = True
    desc_all[:n_seed] = from_numpy(desc, dev)
    state = state.replace(map=m.replace(X=X_all, valid=valid, desc=desc_all),
                          last_tracking=torch.ones((), dtype=torch.bool, device=dev))
    image = torch.from_numpy(rng.random((480, 640), np.float32)).to(dev)
    return fn, (state, image)


def _tiny_slam_config():
    from tinyslam_tpu_torch.config import BAConfig, FrontendConfig, SlamConfig, VOConfig

    return SlamConfig(
        frontend=FrontendConfig(height=64, width=128, num_levels=2, features_per_level=32,
                                border=20),
        ba=BAConfig(max_keyframes=4, max_landmarks=128, max_iters=2),
        vo=VOConfig(max_map_points=128, pnp_iters=3, reloc_hypotheses=32),
    )


def _backend(n: int, device: str) -> tuple[str, str]:
    """(torch.distributed backend, how the ranks share the devices)."""
    if torch.device(device).type == "cpu":
        return "gloo", "gloo-cpu"
    _device(device)
    if torch.cuda.device_count() >= n:
        return "nccl", "nccl"
    return "gloo", f"gloo-cuda-{n}-ranks-on-1-card"


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0) -> str:
    """Run the dry run over ``n_devices`` ranks, one process each; returns
    (and prints) rank 0's line.  Raises if a rank fails."""
    backend, _ = _backend(n_devices, device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tinyslam_tpu_torch.entry", "--rank", str(r), "--world",
         str(n_devices), "--port", str(port), "--device", str(device), "--backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env)
        for r in range(n_devices)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank {r} exited "
                               f"{p.returncode}:\n{log[-4000:]}")
    for x in logs[0].splitlines():
        if x.startswith("track_chunk_dp:"):
            print(x)
    line = [x for x in logs[0].splitlines() if x.startswith("dryrun_multichip(")][-1]
    print(line)
    return line


def _dryrun_rank(rank: int, world: int, port: int, device: str, backend: str) -> None:
    """One rank of the dry run: stages 1, 2, 3, 3b, 3c and 4 of the JAX
    package's ``dryrun_multichip`` on the same tiny shapes and draws."""
    import torch.distributed as dist

    from tinyslam_tpu_torch.backend.pose_graph import optimize_pose_graph_sim3
    from tinyslam_tpu_torch.config import FrontendConfig, MeshConfig
    from tinyslam_tpu_torch.data.synthetic import (
        default_camera, orbit_trajectory, project_points, random_points,
    )
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.geometry.se3 import se3_compose, se3_inverse
    from tinyslam_tpu_torch.models.vo_device import VOState
    from tinyslam_tpu_torch.parallel import (
        bundle_adjust_sharded, extract_features_batch, initialize_multihost, make_mesh,
        optimize_pose_graph_node_sharded, optimize_pose_graph_sharded, track_chunk_dp,
    )
    from tinyslam_tpu_torch.utils.draws import Sampler

    n = world
    _, how = _backend(n, device)
    initialize_multihost(f"127.0.0.1:{port}", n, rank, backend=backend)
    kind = torch.device(device).type
    dev = torch.device("cpu")
    if kind == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    timings: list[tuple[str, float]] = []

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if kind == "cuda":
            torch.cuda.synchronize(dev)
        timings.append((name, time.perf_counter() - t0))
        return out

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    frame_ax = 2 if n % 2 == 0 else 1
    la = n // frame_ax
    mesh = make_mesh(MeshConfig(frame_axis=frame_ax, landmark_axis=la), kind)

    # Stage 1: front-end frame DP, a batch of tiny frames split on `frame`.
    cfg = FrontendConfig(height=64, width=128, num_levels=2, features_per_level=32, border=16)
    rng = np.random.default_rng(1)
    images = T(rng.random((frame_ax * 2, 64, 128), np.float32))
    feats = timed("frontend_dp", lambda: extract_features_batch(images, 0.08, cfg, mesh=mesh))
    total = int(feats.valid.sum())

    # Stage 2: landmark-sharded window BA.
    cam = default_camera(128, 64)
    K, L = 4, 64 * n
    X = random_points(rng, L).astype(np.float32)
    poses = orbit_trajectory(K)
    z = np.zeros((L, K, 2), np.float32)
    mask = np.zeros((L, K), bool)
    for k, (R, t) in enumerate(poses):
        uv, vis = project_points(cam, R, t, X, width=128, height=64, noise_px=0.3, rng=rng)
        z[:, k] = uv
        mask[:, k] = vis
    pose_free = np.r_[[False, False], np.ones(K - 2, bool)]
    X0 = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    ba = timed("ba_sharded", lambda: bundle_adjust_sharded(
        mesh, cam, T(np.stack([p[0] for p in poses]).astype(np.float32)),
        T(np.stack([p[1] for p in poses]).astype(np.float32)),
        T(X0), T(z), T(mask), T(pose_free), max_iters=3))

    # Stage 3: edge-sharded pose graph, an odometry chain and one loop edge,
    # the edges padded to a multiple of the landmark axis.
    N = 16
    gt = orbit_trajectory(N)
    E = ((N + 1 + la - 1) // la) * la
    ei = np.zeros((E,), np.int32)
    ej = np.zeros((E,), np.int32)
    eR = np.tile(np.eye(3, dtype=np.float32)[None], (E, 1, 1))
    et = np.zeros((E, 3), np.float32)
    ev = np.zeros((E,), bool)

    def rel(a, b):
        Ri, ti = se3_inverse(*(torch.from_numpy(np.asarray(x, np.float32)) for x in gt[a]))
        Rb, tb = (torch.from_numpy(np.asarray(x, np.float32)) for x in gt[b])
        return (x.numpy() for x in se3_compose(Rb, tb, Ri, ti))

    for k in range(N - 1):
        ei[k], ej[k] = k, k + 1
        eR[k], et[k] = rel(k, k + 1)
        ev[k] = True
    ei[N - 1], ej[N - 1] = 0, N - 1
    eR[N - 1], et[N - 1] = rel(0, N - 1)
    ev[N - 1] = True
    R0 = np.stack([np.asarray(p[0], np.float32) for p in gt])
    t0 = np.stack([np.asarray(p[1], np.float32) for p in gt]) + rng.normal(
        0, 0.05, (N, 3)).astype(np.float32)
    edges = [T(a) for a in (ei, ej, eR, et, ev)]
    pg = timed("pose_graph_sharded", lambda: optimize_pose_graph_sharded(
        mesh, T(R0), T(t0), *edges, iters=5))

    # Stage 3b: node-sharded pose graph on the whole world as one axis.
    mesh1d = make_mesh(MeshConfig(frame_axis=1, landmark_axis=n), kind)
    Npad = ((N + n - 1) // n) * n
    Rn = np.tile(np.eye(3, dtype=np.float32)[None], (Npad, 1, 1))
    tn = np.zeros((Npad, 3), np.float32)
    Rn[:N], tn[:N] = R0, t0
    pgn = timed("pose_graph_node_sharded", lambda: optimize_pose_graph_node_sharded(
        mesh1d, T(Rn), T(tn), *edges, iters=4, halo=2))

    # Stage 3c: the Sim(3) pose graph (monocular scale drift), unsharded.
    pgs = timed("pose_graph_sim3", lambda: optimize_pose_graph_sim3(
        T(R0), T(t0), torch.ones(N, device=dev), *edges[:4],
        torch.ones(E, device=dev), edges[4], iters=3))

    # Stage 4: B independent sequences, each a VOState, tracked a chunk of
    # C frames under frame DP (the fleet-tracking deployment).
    tcfg = _tiny_slam_config()
    tcam = PinholeCamera.create(fx=64.0, fy=64.0, cx=63.5, cy=31.5)
    B, C = frame_ax, 2
    state1 = VOState.empty(tcfg, dev)
    n_seed = 32
    Xs = rng.normal(0.0, 1.0, (n_seed, 3)).astype(np.float32) + [0, 0, 4.0]
    X_all, valid = state1.map.X.clone(), state1.map.valid.clone()
    X_all[:n_seed] = T(Xs.astype(np.float32))
    valid[:n_seed] = True
    state1 = state1.replace(map=state1.map.replace(X=X_all, valid=valid),
                            last_tracking=torch.ones((), dtype=torch.bool, device=dev))
    states = VOState.stack([state1] * B)
    frames = T(rng.random((B, C, 64, 128), np.float32))
    _, ys = timed("track_chunk_dp", lambda: track_chunk_dp(
        mesh, tcam, tcfg, states, frames, [[True] * C] * B, [Sampler(b) for b in range(B)]))

    def costs(out):
        c = out["costs"].cpu().numpy()
        return f"{float(c[0]):.4f}->{float(c[-1]):.4f}"

    stage_str = " ".join(f"{name}={dt * 1e3:.0f}ms" for name, dt in timings)
    if rank == 0:
        from tinyslam_tpu_torch.models.vo_device import _BATCH_GRAPHS

        replays = sum(g.replays for g in _BATCH_GRAPHS.values())
        print(f"track_chunk_dp: {'the captured BatchGraph' if replays else 'the plain step'}, "
              f"{replays} replays on rank 0", flush=True)
        print(f"dryrun_multichip({n}): mesh={{'frame': {frame_ax}, 'landmark': {la}}} "
              f"features={total} ba_cost={float(ba['initial_cost']):.2f}"
              f"->{float(ba['cost']):.2f} pg_cost={costs(pg)} pg_node_cost={costs(pgn)} "
              f"pg_sim3_cost={costs(pgs)} "
              f"tracked_summary_shape={tuple(ys['summary'].shape)} backend={how} "
              f"device={dev.type} | {stage_str}", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dryrun", type=int, help="run dryrun_multichip over this many ranks")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank", type=int)
    p.add_argument("--world", type=int)
    p.add_argument("--port", type=int)
    p.add_argument("--backend")
    a = p.parse_args(argv)
    if a.rank is not None:
        _dryrun_rank(a.rank, a.world, a.port, a.device, a.backend)
    elif a.dryrun is not None:
        dryrun_multichip(a.dryrun, a.device)
    else:
        fn, args = entry(a.device)
        _, ys = fn(*args)
        print("summary", [round(float(x), 6) for x in ys["summary"].cpu()])
    return 0


if __name__ == "__main__":
    sys.exit(main())
