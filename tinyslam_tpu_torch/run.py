"""Command line: run VO or SLAM over a sequence (mirrors
``tinyslam_tpu/run.py``).

    python -m tinyslam_tpu_torch.run --dataset tum --root /data/fr1_desk \\
        --output traj.txt --metrics metrics.json
    python -m tinyslam_tpu_torch.run --dataset synthetic --frames 60
    python -m tinyslam_tpu_torch.run --mode vo --tracker host --device cpu

``--mode slam`` (the default) runs Sim(3) loop closure over the tracker,
``--mode vo`` the tracker alone; ``--tracker device`` (the default) is the
chunked ``DeviceVO``, ``--tracker host`` the host-stepped
``VisualOdometry``.  Everything runs on ``--device`` (default ``cuda``;
``cpu`` takes the kernels' plain versions).  ``--dataset tum`` reads a
TUM RGB-D sequence, ``euroc`` a EuRoC ASL one, through the native frame
loader and undistorted on the host, with the dataset's intrinsics unless
``--fx/--fy/--cx/--cy`` override them; ``synthetic`` renders the built-in
textured room.  Prints one summary line (and the ATE where there is ground
truth).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=["tum", "euroc", "synthetic"], default="synthetic")
    ap.add_argument("--root", help="sequence directory (tum/euroc)")
    ap.add_argument("--config", help="SlamConfig JSON file")
    ap.add_argument("--mode", choices=["vo", "slam"], default="slam")
    ap.add_argument("--tracker", choices=["device", "host"], default="device",
                    help="device = the chunked tracker (a few syncs a frame, poses "
                         "read back a chunk at a time); host = the host-stepped "
                         "tracker (reads back every decision)")
    ap.add_argument("--chunk", type=int, default=16, help="frames per chunk (device tracker)")
    ap.add_argument("--frames", type=int, default=0, help="limit the frame count")
    ap.add_argument("--output", help="trajectory output (TUM format)")
    ap.add_argument("--metrics", help="metrics JSON output")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--fx", type=float)
    ap.add_argument("--fy", type=float)
    ap.add_argument("--cx", type=float)
    ap.add_argument("--cy", type=float)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tinyslam_tpu_torch.config import SlamConfig
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models import DeviceSlam, DeviceVO, Slam, VisualOdometry
    from tinyslam_tpu_torch.utils.draws import Sampler
    from tinyslam_tpu_torch.utils.evaluation import ate_rmse
    from tinyslam_tpu_torch.utils.metrics import Metrics

    cfg = SlamConfig()
    if args.config:
        with open(args.config) as f:
            cfg = SlamConfig.from_json(f.read())
    device = torch.device(args.device)

    gt_positions = None
    if args.dataset == "synthetic":
        from tinyslam_tpu_torch.data.synthetic import vo_sequence

        n = args.frames or 60
        cam, frames_np, gt_poses, _ = vo_sequence(
            np.random.default_rng(7), num_frames=n, width=min(cfg.frontend.width, 320),
            height=min(cfg.frontend.height, 240))
        frame_iter = ((i * 0.033, f) for i, f in enumerate(frames_np))
        gt_positions = np.stack([-(R.T @ t) for R, t in gt_poses])
    else:
        if args.dataset == "tum":
            from tinyslam_tpu_torch.data.tum import FR1_INTRINSICS as intr
            from tinyslam_tpu_torch.data.tum import TumSequence as Sequence
        else:
            from tinyslam_tpu_torch.data.euroc import EUROC_CAM0 as intr
            from tinyslam_tpu_torch.data.euroc import EurocSequence as Sequence
        seq = Sequence.open(args.root)
        cam = PinholeCamera.create(fx=args.fx or intr["fx"], fy=args.fy or intr["fy"],
                                   cx=args.cx or intr["cx"], cy=args.cy or intr["cy"])
        frame_iter = seq.frames()
        if seq.groundtruth:
            gt_positions = seq.gt_positions()

    if args.mode == "slam":
        system = (DeviceSlam(cfg, cam, chunk=args.chunk, device=device)
                  if args.tracker == "device" else Slam(cfg, cam, device=device))
    else:
        system = (DeviceVO(cfg, cam, chunk=args.chunk, device=device)
                  if args.tracker == "device"
                  else VisualOdometry(cfg, cam, device=device, sampler=Sampler()))
    metrics = Metrics()
    timestamps = []
    t0 = time.time()
    try:
        for ts, img in frame_iter:
            if args.frames and len(timestamps) >= args.frames:
                break
            img = np.asarray(img)
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            with metrics.timer("frame"):
                st = system.process_frame(img) if args.mode == "slam" else system.process(img)
            metrics.step()
            if st is not None:      # the device tracker's stats lag by a chunk
                metrics.record("features", st.num_features)
                metrics.record("inliers", st.num_inliers)
                metrics.record("tracking", int(st.tracking))
            timestamps.append(ts)
    finally:
        frame_iter.close()          # stops the loader's workers at --frames
    if hasattr(system, "finalize"):
        system.finalize()
    elif hasattr(system, "flush"):
        system.flush()
    wall = time.time() - t0
    n_frames = len(timestamps)

    vo = system.vo if args.mode == "slam" else system
    tracked = sum(1 for s in vo.stats if s.tracking)
    line = (f"frames={n_frames} tracked={tracked} keyframes={vo.num_keyframes} "
            f"landmarks={int(vo.map.valid.sum())} fps={n_frames / max(wall, 1e-9):.1f}")
    if args.mode == "slam":
        line += f" loop_closures={system.num_loop_closures}"
    print(line)

    if gt_positions is not None and tracked > 5:
        first = next(i for i, s in enumerate(vo.stats) if s.tracking)
        n_eval = min(len(vo.positions), len(gt_positions))
        ate = ate_rmse(vo.positions[first:n_eval], gt_positions[first:n_eval])
        print(f"ATE RMSE (Sim3): {ate:.4f} m")
    if args.output:
        with open(args.output, "w") as f:
            for ts, (R, t) in zip(timestamps, vo.trajectory):
                C = -R.T @ t
                f.write(f"{ts:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} 0 0 0 1\n")
    if args.metrics:
        metrics.dump(args.metrics)
    if hasattr(system, "close"):
        system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
