#!/usr/bin/env python3
"""Drive the PyTorch port of the tracker once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:
  1. the card: name and power limit (nvidia-smi), torch, CUDA and nvcc;
  2. build the CUDA kernels from tinyslam_tpu_torch/csrc at first use;
  3. K1, the fused FAST kernel, against its plain PyTorch version on the
     four pyramid levels of a rendered 640x480 frame;
  4. K2, the streaming Hamming matcher, against its plain version at
     N=2048 features x M=8192 map points, guided and unguided;
  5. the tracked-frame slice at full width: frame 0 seeds the map at its
     ray-cast 3D points, DeviceVO tracks frames 1-24 of the bench orbit on
     the card; every frame must track, camera centres must stay within
     5 cm of ground truth, the first 8 frames must agree with the same
     slice run on the CPU with the plain versions, and both kernels' launch
     counters must show the main path went through them;
  6. the kernels and their plain versions timed at the shapes of phases
     3 and 4 (device time from the profiler, wall time per call).
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT = 640, 480
N_FRAMES = 25          # frame 0 seeds the map, frames 1-24 are tracked
CHUNK = 8
K1_EXACT = ("score_raw", "score_nms")
K1_TOL = {"m10": 1e-4, "m01": 1e-4, "blurred": 1e-6}   # absolute


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn, reps: int = 100, warmup: int = 10) -> float:
    """Wall time of one call, from CUDA events around `reps` back-to-back
    calls: the rate at which the host can issue it, or the device can run
    it, whichever is slower."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 20) -> float:
    """Device time of one call: the summed duration of every kernel (and
    memset/copy) it runs, from the profiler's CUDA trace, over `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / reps / 1e3


def _centres(R, t) -> np.ndarray:
    return np.stack([-Ri.T @ ti for Ri, ti in zip(R, t)])


def _seeded(cfg, feats, room, cam, pose):
    """VOState whose map holds the valid features of one frame at their
    ray-cast ground-truth 3D points, at that frame's pose."""
    import torch

    from tinyslam_tpu_torch.models.vo_device import VOState

    xy = feats.xy[feats.valid].cpu().numpy().astype(np.float64)
    X = torch.from_numpy(room.raycast(cam, *pose, xy).astype(np.float32))
    R, t = (torch.from_numpy(np.asarray(a)) for a in pose)
    return VOState.seeded(cfg, feats, X, R, t)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from tinyslam_tpu_torch import slice_config
    from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models.vo_device import DeviceVO, VOState, track_chunk
    from tinyslam_tpu_torch.ops import cuda_build, fast_cuda, match_cuda
    from tinyslam_tpu_torch.ops.fast import fast_maps
    from tinyslam_tpu_torch.ops.hamming import match_reduce_plain
    from tinyslam_tpu_torch.ops.image import build_pyramid

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)

    # ---- 1. the card ------------------------------------------------------
    smi = _smi()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    nvcc = subprocess.run([cuda_build._find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    print("nvcc:", nvcc.strip().splitlines()[-1])

    # ---- 2. build -----------------------------------------------------------
    path, log, secs = cuda_build.build()
    cuda_build.load_library()
    print(f"build: {secs:.1f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("  ptxas:", line.strip())

    cfg = slice_config()
    fe = cfg.frontend
    cam = PinholeCamera.create(fx=520.0, fy=520.0, cx=WIDTH / 2 - 0.5,
                               cy=HEIGHT / 2 - 0.5)
    room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
    poses = orbit_trajectory(N_FRAMES, radius=2.0, step=0.02, start=-0.35,
                             target=(0.0, 0.0, 2.0))
    t0 = time.perf_counter()
    frames = [room.render(cam, R, t, WIDTH, HEIGHT) for R, t in poses]
    print(f"rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s")

    # ---- 3. K1 against plain ---------------------------------------------
    thr = torch.tensor(fe.threshold, dtype=torch.float32, device=dev)
    levels = build_pyramid(torch.from_numpy(frames[0]).to(dev), fe.num_levels)
    timed = []      # (label, kernel call, plain call), timed in phase 6
    k1_err = 0.0
    names = ("score_raw", "score_nms", "m10", "m01", "blurred")
    for lvl in levels:
        run_k = lambda lvl=lvl: fast_cuda.fast_score_map_fused(
            lvl, thr, fe.border, fe.streak_length, fe.blur_sigma)
        run_p = lambda lvl=lvl: fast_maps(lvl, thr, fe.border, fe.streak_length,
                                          fe.blur_sigma)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            err = float((g - w).abs().max())
            if name in K1_EXACT and not torch.equal(g, w):
                raise AssertionError(f"K1 {name} at {tuple(lvl.shape)}: not "
                                     f"bit-equal (max |diff| {err})")
            if name in K1_TOL and not err <= K1_TOL[name]:
                raise AssertionError(f"K1 {name} at {tuple(lvl.shape)}: "
                                     f"max |diff| {err} > {K1_TOL[name]}")
            k1_err = max(k1_err, err)
        print(f"K1 {tuple(lvl.shape)}: corners {int((got[1] > 0).sum())}, "
              f"max |diff| {k1_err}")
        timed.append((f"K1 {tuple(lvl.shape)}", run_k, run_p))

    # ---- 4. K2 against plain ---------------------------------------------
    seed_feats = extract_features(torch.from_numpy(frames[0]).to(dev), thr, fe)
    feats1 = extract_features(torch.from_numpy(frames[1]).to(dev), thr, fe)
    m_state = _seeded(cfg, seed_feats, room, cam, poses[0]).map
    R0 = torch.from_numpy(poses[0][0]).to(dev)
    t0_ = torch.from_numpy(poses[0][1]).to(dev)
    pc = m_state.X @ R0.T + t0_
    proj = torch.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                        cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    rng = np.random.default_rng(5)
    n, m = fe.max_features, cfg.vo.max_map_points
    rdesc_b = rng.integers(0, 2**32 - 1, (m, 8), np.uint32)
    rdesc_b[rng.integers(0, m, m // 5)] = rdesc_b[rng.integers(0, m, m // 5)]
    rdesc_a = rdesc_b[rng.integers(0, m, n)].copy()
    rdesc_a[:, 0] ^= rng.integers(0, 2**8, n).astype(np.uint32)
    T = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    rand_case = dict(
        desc_a=T(rdesc_a.view(np.int32)), valid_a=T(rng.random(n) > 0.1),
        desc_b=T(rdesc_b.view(np.int32)), valid_b=T(rng.random(m) > 0.1),
        xy_a=T(rng.uniform(0, 640, (n, 2)).astype(np.float32)),
        proj_b=T(rng.uniform(0, 640, (m, 2)).astype(np.float32)))
    real = dict(desc_a=feats1.desc, valid_a=feats1.valid, desc_b=m_state.desc,
                valid_b=m_state.valid, xy_a=feats1.xy, proj_b=proj)
    unguided = lambda c: {k: v for k, v in c.items() if k not in ("xy_a", "proj_b")}
    cases = [("real guided r=20", real, 20.0), ("real guided r=8", real, 8.0),
             ("real unguided", unguided(real), 0.0),
             ("random guided r=20", rand_case, 20.0),
             ("random unguided", unguided(rand_case), 0.0)]
    for name, case, r in cases:
        got = match_cuda.match_reduce(**case, radius_px=r)
        want = match_reduce_plain(**case, radius_px=r)
        for label, g, w in zip(("best", "second", "idx_b", "col_idx"), got, want):
            if not torch.equal(g, w.to(g.dtype)):
                bad = int((g != w).sum())
                raise AssertionError(f"K2 {name}: {label} differs at {bad} slots")
        n_match = int(((got[0] <= cfg.matcher.max_distance)
                       & (got[0].float() <= cfg.matcher.ratio * got[1].float())).sum())
        print(f"K2 {name}: N={case['desc_a'].shape[0]} M={case['desc_b'].shape[0]} "
              f"exact; rows passing distance+ratio {n_match}")
    timed.append(("K2 real guided r=20",
                  lambda: match_cuda.match_reduce(**real, radius_px=20.0),
                  lambda: match_reduce_plain(**real, radius_px=20.0)))

    # ---- 5. the slice on the card ----------------------------------------
    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = 0
    match_cuda.LAUNCHES = 0
    feats0 = extract_features(torch.from_numpy(frames[0]).to(dev), thr, fe)
    seed = _seeded(cfg, feats0, room, cam, poses[0])
    print(f"seeded map: {int(seed.map.valid.sum())} landmarks of "
          f"{cfg.vo.max_map_points}")
    vo = DeviceVO(cfg, cam, chunk=CHUNK)
    vo.state = seed
    chunk_s = []    # the first chunk is the warm-up
    for c in range((N_FRAMES - 1) // CHUNK):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for im in frames[1 + c * CHUNK: 1 + (c + 1) * CHUNK]:
            vo.process(im)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t_start)
    vo.flush()
    launches = {"fast_score_map_fused": fast_cuda.LAUNCHES,
                "match_reduce_streaming": match_cuda.LAUNCHES}
    stats = vo.stats
    n_timed = N_FRAMES - 1 - CHUNK
    print("inliers per frame:", [s.num_inliers for s in stats], f" [{card}]")
    print(f"tracked fps (frames {CHUNK + 1}-{N_FRAMES - 1}, after a warm-up "
          f"chunk): {n_timed / sum(chunk_s[1:]):.2f}; ms/frame per chunk "
          f"{[round(t * 1e3 / CHUNK, 3) for t in chunk_s]}  [{smi}]")

    tracked = sum(s.tracking for s in stats)
    est = vo.positions
    gt = _centres([p[0] for p in poses[1:]], [p[1] for p in poses[1:]])
    if est.shape != (N_FRAMES - 1, 3) or not np.isfinite(est).all():
        raise AssertionError(f"trajectory shape {est.shape} or non-finite")
    err = np.linalg.norm(est - gt, axis=1)
    print(f"tracked {tracked}/{N_FRAMES - 1}; camera-centre error vs ground "
          f"truth: max {err.max():.4f} m, mean {err.mean():.4f} m")
    if tracked != N_FRAMES - 1:
        raise AssertionError(f"tracked only {tracked}/{N_FRAMES - 1} frames")
    if not err.max() < 0.05:
        raise AssertionError(f"camera-centre error {err.max():.4f} m >= 0.05 m")
    print("launches during the slice:", launches)
    if launches["fast_score_map_fused"] != 4 * N_FRAMES:
        raise AssertionError(f"K1 launched {launches['fast_score_map_fused']} "
                             f"times, expected {4 * N_FRAMES}")
    if launches["match_reduce_streaming"] < N_FRAMES - 1:
        raise AssertionError(f"K2 launched {launches['match_reduce_streaming']} "
                             f"times, expected >= {N_FRAMES - 1}")

    # Reference on a small input: the same slice on the CPU (plain
    # versions, no kernels) over the first chunk must agree with the card.
    cpu_state = VOState.from_numpy(seed.to_numpy(), "cpu")
    _, ys = track_chunk(cam, cfg, cpu_state,
                        torch.from_numpy(np.stack(frames[1:1 + CHUNK])),
                        [True] * CHUNK)
    cpu_c = _centres(ys["R"].numpy(), ys["t"].numpy())
    cpu_in = ys["summary"][:, 2].numpy()
    gpu_in = np.array([s.num_inliers for s in stats[:CHUNK]])
    dc = float(np.abs(cpu_c - est[:CHUNK]).max())
    din = float(np.max(np.abs(cpu_in - gpu_in) / np.maximum(cpu_in, 1)))
    print(f"card vs CPU plain path, frames 1-{CHUNK}: max centre diff {dc:.2e} m, "
          f"max relative inlier diff {din:.4f}")
    if not (dc < 2e-3 and din <= 0.02):
        raise AssertionError("card and CPU plain path disagree")

    # ---- 6. kernel times -----------------------------------------------------
    # Last: once the profiler has run in a process, every later launch
    # costs more on the host, which would distort the tracked fps above.
    ms = {}
    for label, run_k, run_p in timed:
        ms[label] = (_device_ms(run_k), _device_ms(run_p))
        print(f"{label}: device kernel {ms[label][0]:.4f} ms, plain "
              f"{ms[label][1]:.4f} ms; wall per call kernel {_time_ms(run_k):.4f} "
              f"ms, plain {_time_ms(run_p, reps=20):.4f} ms  [{smi}]")
    k1 = [v for k, v in ms.items() if k.startswith("K1")]
    k1_ms, k1_plain_ms = sum(v[0] for v in k1), sum(v[1] for v in k1)
    k2_ms, k2_plain_ms = ms["K2 real guided r=20"]
    print(f"K1 one frame (4 levels), device: kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms  [{smi}]")

    kernels = [
        {"name": "fast_score_map_fused", "route": "cuda",
         "source": "tinyslam_tpu_torch/csrc/fast.cu",
         "replaces": "tinyslam_tpu/ops/fast_pallas.py:258",
         "launches": launches["fast_score_map_fused"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "match_reduce_streaming", "route": "cuda",
         "source": "tinyslam_tpu_torch/csrc/match.cu",
         "replaces": "tinyslam_tpu/ops/match_pallas.py:140",
         "launches": launches["match_reduce_streaming"],
         "max_abs_err": 0.0, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
