"""Accuracy evaluation on the rendered dataset-like sequences (the
counterpart of ``tools/eval_ate.py``; it imports nothing of that file).

The three sequences reproduce the statistics of TUM fr1_desk, of a
full-circuit fr1 walk that returns to its start, and of EuRoC MH_01: full
resolution, the datasets' intrinsics and lens distortion, handheld or MAV
motion, vignetting, auto-exposure hunting, sensor noise and 8-bit
quantization.  They are written in the datasets' layouts, so the eval runs
the native loader and the undistortion end to end, and each builder writes
files byte-identical to the JAX tool's.  The clean ray casts run on
spawned worker processes; the generator's draws (room, trajectory,
exposure, noise) stay in the caller's order.

    python -m tinyslam_tpu_torch.eval_ate [--frames N] [--out EVAL.json]
        [--keep DIR] [--mode slam|vo] [--tracker device|host]
        [--only fr1|fr1_loop|mh01] [--seed S] [--device cuda|cpu]

Prints one JSON line per sequence and writes the combined artifact, with
the JAX tool's keys and the card's ``nvidia-smi`` name and power limit.
Without ``--keep`` the sequences are rendered once into
``build/tinyslam_tpu_torch/seq/`` (keyed by the sequence's parameters and
the renderer's sources) and reused by later runs and by ``chip_smoke.py``.
Everything runs on ``--device`` (default ``cuda``, which raises where
there is no card); ``--seed`` seeds the RANSAC ``Sampler``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tinyslam_tpu_torch.config import SlamConfig
from tinyslam_tpu_torch.data import synthetic as syn
from tinyslam_tpu_torch.data.euroc import EUROC_CAM0, EUROC_DIST, EurocSequence
from tinyslam_tpu_torch.data.tum import FR1_DIST, FR1_INTRINSICS, TumSequence
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models import DeviceSlam, DeviceVO, Slam, VisualOdometry
from tinyslam_tpu_torch.utils.draws import Sampler
from tinyslam_tpu_torch.utils.evaluation import ate_rmse, rpe

SEQ_DIR = Path(__file__).resolve().parents[1] / "build" / "tinyslam_tpu_torch" / "seq"
# --only's names -> the artifact's sequence names.
SEQUENCES = {"fr1": "fr1_desk_like", "fr1_loop": "fr1_loop_like", "mh01": "mh01_like"}


# ---------------- the sequences ----------------
def fr1_desk_spec(num_frames: int, tex_res: int = 256) -> dict:
    """fr1_desk-like: a cluttered desk scene (clutter raises occlusion and
    depth discontinuities and gives the texture local structure a
    descriptor can tell apart), a slow handheld arc, 640x480 through the
    distorted fr1 camera."""
    return dict(kind="tum", seed=101, frames=num_frames, width=640, height=480,
                room=dict(tex_res=tex_res, octaves=4, clutter=8))


def fr1_loop_spec(num_frames: int, tex_res: int = 256) -> dict:
    """fr1_loop-like: a full-circuit handheld walk (~378 degrees) that
    returns to its start, the revisit a loop closure needs (fr1's room
    statistics otherwise).  The step scales with ``num_frames``, so a
    shorter sequence still closes the circuit."""
    return dict(kind="tum", seed=303, frames=num_frames, width=640, height=480,
                room=dict(tex_res=tex_res, octaves=4, clutter=10),
                trajectory=dict(step=(2.0 * np.pi + 0.35) / num_frames,
                                jitter_pos=0.003, jitter_tgt=0.008))


def mh01_spec(num_frames: int, tex_res: int = 256) -> dict:
    """mh01-like: a large hall, a fast MAV arc, 752x480 through EuRoC's
    camera."""
    return dict(kind="euroc", seed=202, frames=num_frames, width=752, height=480,
                room=dict(half_size=(8.0, 5.0, 8.0), tex_res=tex_res, octaves=4,
                          clutter=16))


SPECS = {"fr1": fr1_desk_spec, "fr1_loop": fr1_loop_spec, "mh01": mh01_spec}


def _scene(spec: dict):
    """The builder of ``spec``: (the generator after the room's and the
    trajectory's draws, room, camera, poses, distortion)."""
    tum = spec["kind"] == "tum"
    rng = np.random.default_rng(spec["seed"])
    room = syn.TexturedRoom(rng, **spec["room"])
    cam = PinholeCamera.create(**(FR1_INTRINSICS if tum else EUROC_CAM0))
    trajectory = syn.handheld_trajectory if tum else syn.mav_trajectory
    poses = trajectory(rng, spec["frames"], **spec.get("trajectory", {}))
    return rng, room, cam, poses, FR1_DIST if tum else EUROC_DIST


def _spec_scene(spec: dict):
    """(room, camera, poses, distortion, width, height) of ``spec``."""
    _, room, cam, poses, dist = _scene(spec)
    return room, cam, poses, dist, spec["width"], spec["height"]


# ---------------- the parallel renderer ----------------
_WORKER_SCENE = None


def _init_worker(scene, args) -> None:
    global _WORKER_SCENE
    _WORKER_SCENE = scene(*args)


def _render_one(i: int) -> np.ndarray:
    room, cam, poses, dist, w, h = _WORKER_SCENE
    return room.render(cam, *poses[i], w, h, dist=dist)


def render_clean(scene, args: tuple, n: int, workers: int | None = None) -> list[np.ndarray]:
    """The clean ray casts of the first ``n`` poses of ``scene(*args)``
    (a picklable function returning (room, camera, poses, distortion,
    width, height)) on ``workers`` spawned processes."""
    workers = workers or min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(workers, _init_worker, (scene, args)) as pool:
        return pool.map(_render_one, range(n))


class _Rendered:
    """Stands in for the room in ``render_sequence``: hands back the clean
    frames rendered beforehand, in order, so that the generator's draws
    (the exposure track, then one noise image a frame) stay its own."""

    def __init__(self, images):
        self._images = iter(images)

    def render(self, cam, R, t, width, height, dist=None):
        return next(self._images)


def _write(spec: dict, root: Path, workers: int | None) -> np.ndarray:
    """Render ``spec``'s sequence and write it under ``root`` in its
    dataset's layout; returns the first frame."""
    rng, _, cam, poses, dist = _scene(spec)
    clean = render_clean(_spec_scene, (spec,), len(poses), workers)
    frames = syn.render_sequence(rng, poses, cam, spec["width"], spec["height"],
                                 _Rendered(clean), dist=dist)
    if spec["kind"] == "tum":
        syn.write_tum_sequence(root, frames, poses, fps=30.0)
    else:
        syn.write_euroc_sequence(root, frames, poses, fps=20.0)
    return frames[0]


def build_fr1_desk_like(root, num_frames: int, workers: int | None = None,
                        tex_res: int = 256) -> None:
    _write(fr1_desk_spec(num_frames, tex_res), Path(root), workers)


def build_fr1_loop_like(root, num_frames: int, workers: int | None = None,
                        tex_res: int = 256) -> None:
    _write(fr1_loop_spec(num_frames, tex_res), Path(root), workers)


def build_mh01_like(root, num_frames: int, workers: int | None = None,
                    tex_res: int = 256) -> None:
    _write(mh01_spec(num_frames, tex_res), Path(root), workers)


def dataset_sequence(spec: dict, workers: int | None = None) -> tuple[Path, float]:
    """``spec``'s sequence written under SEQ_DIR, with its first frame as
    ``frame0.npy``, keyed by a hash of ``spec`` and of the renderer's
    sources; a sequence written already is reused.  Returns (its
    directory, seconds spent, 0 if reused)."""
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    for path in [Path(syn.__file__).parent / name
                 for name in ("synthetic.py", "undistort.py", "png.py")] + [Path(__file__)]:
        key.update(path.read_bytes())
    root = SEQ_DIR / f"{spec['kind']}_{key.hexdigest()[:12]}"
    if (root / "frame0.npy").exists():
        return root, 0.0
    t_start = time.perf_counter()
    tmp = root.with_name(f"{root.name}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    np.save(tmp / "frame0.npy", _write(spec, tmp, workers))
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)
    return root, time.perf_counter() - t_start


# ---------------- one run ----------------
def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tinyslam_tpu_torch.eval_ate: CUDA is not available; pass "
                           "--device cpu for the CPU")
    return dev


def run_sequence(name: str, kind: str, root, mode: str, tracker: str = "device", *,
                 device, sampler: Sampler | None = None, frames: int | None = None) -> dict:
    """Track the sequence under ``root`` (``kind`` "tum" or "euroc") with
    ``mode`` "slam" (loop closure over the tracker) or "vo" and ``tracker``
    "device" (the chunked tracker) or "host", on ``device``, drawing from
    ``sampler`` (``Sampler(0)`` if None), over its first ``frames`` frames
    (all if None).  The loader's uint8 frames go to the tracker as they
    are, as the JAX tool feeds them.  Prints and returns the JAX tool's
    fields."""
    dev = _device(device)
    sampler = Sampler(0) if sampler is None else sampler
    if kind == "tum":
        seq = TumSequence.open(root)
        cam = PinholeCamera.create(**FR1_INTRINSICS)
    else:
        seq = EurocSequence.open(root)
        cam = PinholeCamera.create(**EUROC_CAM0)
    gt = seq.gt_positions()

    # The loader alone (PNG decode and undistortion on the host): how much
    # of the end-to-end rate is the data layer.
    t0 = time.perf_counter()
    n_probe = 0
    for _ in seq.frames():
        n_probe += 1
        if n_probe >= 50:
            break
    data_fps = n_probe / max(time.perf_counter() - t0, 1e-9)

    cfg = SlamConfig()
    if mode == "slam":
        system = (DeviceSlam(cfg, cam, device=dev, sampler=sampler) if tracker == "device"
                  else Slam(cfg, cam, device=dev, sampler=sampler))
    else:
        system = (DeviceVO(cfg, cam, device=dev, sampler=sampler) if tracker == "device"
                  else VisualOdometry(cfg, cam, device=dev, sampler=sampler))
    step = system.process_frame if mode == "slam" else system.process
    t0 = time.perf_counter()
    n = 0
    stamps = []                         # per-frame completion times
    for _, img in seq.frames():
        if n == frames:
            break
        step(img)
        n += 1
        stamps.append(time.perf_counter())
    if hasattr(system, "finalize"):
        system.finalize()
    elif hasattr(system, "flush"):
        system.flush()                  # reads the poses back: the device is done
    wall = time.perf_counter() - t0
    # Steady state: after the bootstrap and the first tracked chunks.
    warm_n = min(40, max(1, n // 3))
    steady_fps = ((n - warm_n) / max(stamps[-1] - stamps[warm_n - 1], 1e-9)
                  if n > warm_n else float("nan"))
    vo = system.vo if mode == "slam" else system
    tracked = sum(1 for s in vo.stats if s.tracking)
    first = next((i for i, s in enumerate(vo.stats) if s.tracking), 0)
    # SLAM is evaluated on its corrected trajectory (keyframe BA and the
    # pose-graph corrections carried to every frame); the raw online one
    # is the ablation column.
    est = system.positions if mode == "slam" else vo.positions
    traj = system.trajectory if mode == "slam" else vo.trajectory
    m = min(len(est), len(gt))
    ate = ate_rmse(est[first:m], gt[first:m])
    ate_se3 = ate_rmse(est[first:m], gt[first:m], with_scale=False)
    ate_raw = ate_rmse(system.raw_positions[first:m], gt[first:m]) if mode == "slam" else None
    rpe_t, rpe_r = rpe(traj[first:m], [(R, t) for _, R, t in seq.groundtruth][first:m])
    out = {
        "sequence": name,
        "mode": mode,
        "tracker": tracker,
        "frames": n,
        "tracked": tracked,
        "reboots": getattr(vo, "num_reboots", 0),
        "host_frames": getattr(vo, "host_frames", None),
        "keyframes": len(system.kf_store) if mode == "slam" else vo.num_keyframes,
        "loop_closures": getattr(system, "num_loop_closures", 0),
        "ate_rmse_m": round(ate, 4),
        "ate_se3_m": round(ate_se3, 4),
        "ate_raw_m": round(ate_raw, 4) if ate_raw is not None else None,
        "rpe_trans_m": round(rpe_t, 4),
        "rpe_rot_deg": round(rpe_r, 3),
        "fps": round(n / wall, 1),
        "steady_fps": round(steady_fps, 1),
        "warmup_s": round(stamps[warm_n - 1] - t0, 1) if n else 0.0,
        "data_fps": round(data_fps, 1),
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "stage_budget_s": {k: round(v, 2) for k, v in getattr(system, "timings", {}).items()},
        "loop_log_tail": getattr(system, "loop_log", [])[-10:],
    }
    if hasattr(system, "close"):
        system.close()
    print(json.dumps(out), flush=True)
    return out


def nvidia_smi() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--out", default="EVAL.json")
    ap.add_argument("--keep", help="build the sequences in (or reuse them from) this dir")
    ap.add_argument("--mode", choices=["vo", "slam"], default="slam")
    ap.add_argument("--tracker", choices=["device", "host"], default="device")
    ap.add_argument("--only", choices=list(SEQUENCES))
    ap.add_argument("--seed", type=int, default=0, help="the RANSAC sampler's seed")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    smi = nvidia_smi() if dev.type == "cuda" else None

    results = []
    for key, name in SEQUENCES.items():
        if args.only not in (None, key):
            continue
        spec = SPECS[key](args.frames)
        if args.keep:
            root = Path(args.keep) / name
            layout = "rgb.txt" if spec["kind"] == "tum" else "mav0"
            if not (root / layout).exists():
                print(f"building {name} ({args.frames} frames)...", flush=True)
                _write(spec, root, None)
        else:
            root, secs = dataset_sequence(spec)
            print(f"{name}: {root} ({f'rendered in {secs:.1f} s' if secs else 'reused'})",
                  flush=True)
        results.append(run_sequence(name, spec["kind"], root, args.mode, args.tracker,
                                    device=dev, sampler=Sampler(args.seed)))

    artifact = {
        "target_ate_m": 0.05,
        "note": ("rendered sequences with real-dataset statistics "
                 "(intrinsics+distortion+photometrics+interior clutter) in the "
                 "TUM and EuRoC layouts, not the recorded TUM/EuRoC files"),
        "results": results,
        "nvidia_smi": smi,
        "seed": args.seed,
    }
    Path(args.out).write_text(json.dumps(artifact, indent=2))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
