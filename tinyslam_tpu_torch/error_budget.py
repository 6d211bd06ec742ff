"""Per-stage accuracy error budget (the counterpart of
``tools/error_budget.py``; it imports nothing of that file).

Decomposes end-to-end ATE into its contributors:

  1. bootstrap     - residual scale and fit of the two-view init over the
                     first tracked window, against the whole run's alignment;
  2. drift         - windowed Umeyama scale and position error against the
                     distance travelled, with window BA on and off (how much
                     of the drift is scale drift, which only a Sim(3) loop
                     closure removes);
  3. loop gates    - every loop candidate classified against the ground-truth
                     revisits (a true revisit: the two keyframes' frames lie
                     within 1 m of each other), tp/fp/fn/tn, precision,
                     recall and the accepted relative scales ``s_e``;
  4. end-to-end    - the SLAM run's ATE, Sim(3)- and SE(3)-aligned, and that
                     of its raw online trajectory.

    python -m tinyslam_tpu_torch.error_budget [--frames N] [--out ERRBUDGET.json]
        [--keep DIR] [--seq fr1|fr1_loop|mh01 ...] [--device cuda|cpu] [--seed S]

The sequences are ``tinyslam_tpu_torch.eval_ate``'s (rendered once into
``build/tinyslam_tpu_torch/seq/`` and reused, or under ``--keep``).  Each
sequence takes three runs (VO with BA, VO without, SLAM), each from the
same sampler state.  Prints one line per sequence and writes the reports,
with the JAX tool's keys, beside the card's ``nvidia-smi`` name and power
limit and the seed.  Everything runs on ``--device`` (default ``cuda``,
which raises where there is no card).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from tinyslam_tpu_torch import eval_ate
from tinyslam_tpu_torch.config import SlamConfig
from tinyslam_tpu_torch.data.euroc import EUROC_CAM0, EurocSequence
from tinyslam_tpu_torch.data.tum import FR1_INTRINSICS, TumSequence
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models import DeviceSlam, DeviceVO
from tinyslam_tpu_torch.utils.draws import Sampler
from tinyslam_tpu_torch.utils.evaluation import ate_rmse, umeyama_alignment

# --seq's names -> (layout, the report's sequence name, the builder).
BUILDERS = {
    "fr1": ("tum", "fr1_desk_like", eval_ate.build_fr1_desk_like),
    "fr1_loop": ("tum", "fr1_loop_like", eval_ate.build_fr1_loop_like),
    "mh01": ("euroc", "mh01_like", eval_ate.build_mh01_like),
}
REVISIT_M = 1.0         # two keyframes' ground-truth centres closer than this revisit


def _windowed_scale(est: np.ndarray, gt: np.ndarray, win: int = 30) -> list[dict]:
    """Umeyama scale and RMSE of each sliding window: the scale drift profile."""
    out = []
    for a in range(0, len(est) - win, max(win // 2, 1)):
        e, g = est[a:a + win], gt[a:a + win]
        if np.ptp(g, axis=0).max() < 1e-6:
            continue
        s, R, t = umeyama_alignment(e, g, with_scale=True)
        res = (s * (R @ e.T)).T + t - g
        out.append({"frame": a + win // 2, "scale": float(s),
                    "rmse": float(np.sqrt(np.mean(np.sum(res**2, -1))))})
    return out


def _dist_travelled(gt: np.ndarray) -> float:
    return float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))


def _run_system(seq, cam, cfg, mode: str, *, device, sampler):
    """``DeviceSlam`` (``mode`` "slam") or ``DeviceVO`` over every frame of
    ``seq``, the loader's uint8 frames fed as they are; finalized."""
    if mode == "slam":
        system = DeviceSlam(cfg, cam, device=device, sampler=sampler)
    else:
        system = DeviceVO(cfg, cam, device=device, sampler=sampler)
    step = system.process_frame if mode == "slam" else system.process
    for _, img in seq.frames():
        step(img)
    if hasattr(system, "finalize"):
        system.finalize()
    else:
        system.flush()
    return system


def _load(kind: str, root: Path):
    if kind == "tum":
        return TumSequence.open(root), PinholeCamera.create(**FR1_INTRINSICS)
    return EurocSequence.open(root), PinholeCamera.create(**EUROC_CAM0)


def budget_for_sequence(name: str, kind: str, root, *, device, sampler=None,
                        seed: int = 0) -> dict:
    """The four stages on the sequence under ``root`` (``kind`` "tum" or
    "euroc"), on ``device``.  Each of the three runs draws from a fresh
    ``Sampler(seed)``, or from ``sampler``, whose draws must depend on
    their keys alone (as ``JaxSampler``'s do), so that every run starts
    from the same draws."""
    dev = eval_ate._device(device)
    fresh = (lambda: Sampler(seed)) if sampler is None else (lambda: sampler)
    seq, cam = _load(kind, Path(root))
    gt = seq.gt_positions()
    report: dict = {"sequence": name}

    # ---- stage 2: VO drift, BA on and off (no loop closure) ----
    for tag, cfg in (
        ("ba_on", SlamConfig()),
        ("ba_off", SlamConfig().replace(ba=SlamConfig().ba.replace(max_iters=0))),
    ):
        vo = _run_system(seq, cam, cfg, "vo", device=dev, sampler=fresh())
        est = vo.positions
        m = min(len(est), len(gt))
        first = next((i for i, s in enumerate(vo.stats) if s.tracking), 0)
        e, g = est[first:m], gt[first:m]
        # Scale drift is measured within a submap: a reboot re-normalizes the
        # monocular scale, so the profile is taken on the longest submap.
        bounds = sorted({first, m} | {ev["frame"] for ev in vo.submap_events
                                      if first < ev["frame"] < m})
        seg = max(zip(bounds[:-1], bounds[1:]), key=lambda ab: ab[1] - ab[0],
                  default=(first, m))
        wscale = _windowed_scale(est[seg[0]:seg[1]], gt[seg[0]:seg[1]])
        scales = np.array([w["scale"] for w in wscale]) if wscale else np.ones(1)
        dist = _dist_travelled(gt[seg[0]:seg[1]])
        spread = float(np.log(scales.max() / scales.min()))
        report[f"vo_{tag}"] = {
            "tracked": sum(1 for s in vo.stats if s.tracking),
            "frames": m,
            "reboots": vo.num_reboots,
            "drift_segment": [int(seg[0]), int(seg[1])],
            "ate_sim3_m": round(ate_rmse(e, g, with_scale=True), 4),
            "ate_se3_m": round(ate_rmse(e, g, with_scale=False), 4),
            "dist_travelled_m": round(dist, 2),
            # the log-scale spread across windows: the accumulated scale drift
            "scale_drift_logspread": round(spread, 4),
            "scale_drift_per_m": round(spread / max(dist, 1e-6), 5),
            "windowed_scale": wscale,
        }
        if tag == "ba_on":
            # ---- stage 1: the bootstrap, the BA-on run's first tracked window ----
            first_w = slice(first, min(first + 30, m))
            s_boot, _, _ = umeyama_alignment(est[first_w], gt[first_w])
            report["bootstrap"] = {
                "first_tracked_frame": first,
                # the first window's scale against the whole run's: 1.0 when
                # the bootstrap's scale is representative
                "window_scale_vs_run": round(float(s_boot / umeyama_alignment(e, g)[0]), 4),
                "window_rmse_m": round(ate_rmse(est[first_w], gt[first_w]), 4),
            }

    # ---- stages 3 and 4: the SLAM run with its loop gates classified ----
    slam = _run_system(seq, cam, SlamConfig(), "slam", device=dev, sampler=fresh())
    est = slam.positions
    m = min(len(est), len(gt))
    first = next((i for i, s in enumerate(slam.vo.stats) if s.tracking), 0)
    e, g = est[first:m], gt[first:m]
    gt_all = gt[:len(slam.vo.stats)]

    def is_true_revisit(rec) -> bool:
        fi, fj = slam.kf_frame_of.get(rec["kf"]), slam.kf_frame_of.get(rec["old"])
        if fi is None or fj is None or fi >= len(gt_all) or fj >= len(gt_all):
            return False
        return bool(np.linalg.norm(gt_all[fi] - gt_all[fj]) < REVISIT_M)

    tp = fp = fn = tn = 0
    scale_errs = []
    for rec in slam.loop_log:
        truth = is_true_revisit(rec)
        if rec["accepted"] and truth:
            tp += 1
        elif rec["accepted"]:
            fp += 1
        elif truth:
            fn += 1
        else:
            tn += 1
        if rec["accepted"] and truth and np.isfinite(rec["s_e"]):
            scale_errs.append(rec["s_e"])
    report["loop_gates"] = {
        "candidates": len(slam.loop_log),
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": round(tp / max(tp + fp, 1), 3),
        "recall": round(tp / max(tp + fn, 1), 3),
        "accepted_scales": [round(s, 4) for s in scale_errs],
        "log": slam.loop_log[-50:],
    }
    raw = slam.raw_positions
    report["slam"] = {
        "loop_closures": slam.num_loop_closures,
        "keyframes": len(slam.kf_R),
        "reboots": slam.vo.num_reboots,
        "ate_sim3_m": round(ate_rmse(e, g, with_scale=True), 4),
        "ate_se3_m": round(ate_rmse(e, g, with_scale=False), 4),
        # the raw online trajectory: its gap to ate_sim3_m is what keyframe BA
        # and the loop corrections bought
        "ate_raw_sim3_m": round(ate_rmse(raw[first:m], g, with_scale=True), 4),
    }
    return report


def summary_line(report: dict) -> str:
    """The report as one JSON line, without the loop log."""
    gates = {k: v for k, v in report["loop_gates"].items() if k != "log"}
    return json.dumps({k: v for k, v in report.items() if k != "loop_gates"}
                      | {"loop_gates": gates}, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--out", default="ERRBUDGET.json")
    ap.add_argument("--keep", help="build the sequences in (or reuse them from) this dir")
    ap.add_argument("--seq", choices=list(BUILDERS), action="append")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--seed", type=int, default=0, help="the RANSAC sampler's seed")
    args = ap.parse_args(argv)
    dev = eval_ate._device(args.device)
    smi = eval_ate.nvidia_smi() if dev.type == "cuda" else None

    reports = []
    for key in args.seq or list(BUILDERS):
        kind, name, build = BUILDERS[key]
        if args.keep:
            root = Path(args.keep) / name
            if not (root / ("rgb.txt" if kind == "tum" else "mav0")).exists():
                print(f"building {name} ({args.frames} frames)...", flush=True)
                build(root, args.frames)
        else:
            root, secs = eval_ate.dataset_sequence(eval_ate.SPECS[key](args.frames))
            print(f"{name}: {root} ({f'rendered in {secs:.1f} s' if secs else 'reused'})",
                  flush=True)
        print(f"budgeting {name}...", flush=True)
        rep = budget_for_sequence(name, kind, root, device=dev, seed=args.seed)
        print(summary_line(rep), flush=True)
        reports.append(rep)

    Path(args.out).write_text(json.dumps(
        {"reports": reports, "nvidia_smi": smi, "seed": args.seed}, indent=2, default=str))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
