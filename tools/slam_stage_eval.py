"""The accuracy eval's SLAM stages on the card, this tree against another.

    python tools/slam_stage_eval.py --other DIR [--seeds-mh01 N]
        [--out EVAL_torch_pr16.json]

Runs ``tinyslam_tpu_torch.eval_ate.run_sequence`` (``DeviceSlam`` under
``Sampler(0)``, the default ``SlamConfig()``) over the fr1_desk-, fr1_loop-
and mh01-like sequences of ``FRAMES`` frames in one process a tree, in the
order ``ORDER`` (other, this, this, other), each process importing that
tree's package (``DIR`` holds another tree, for example the parent commit
unpacked by ``git archive``).  The sequences are
rendered once, by this tree's builders, into the eval's cache
(``eval_ate.dataset_sequence``: ``build/tinyslam_tpu_torch/seq/``, which
``chip_smoke.py`` phase 14 shares), and both trees read the same files.
Per sequence it keeps the eval's fields (``stage_budget_s``, ``steady_fps``, tracked,
closures, ATE) and, per SLAM stage (``kf_ingest``, ``loop_probe``,
``graph_solve``, ``solve_capture``; ``Slam._timed``'s keys), the calls, the wall ms of each
(host clock; the solve's includes applying the correction) and the ms the
current CUDA stream spent between the stage's start and its end (CUDA
events: a captured stage's replay and copies; for an eager one the same
span, gaps for the host's launches included).  ``--seeds-mh01 N`` then
runs mh01-like under ``Sampler(1)``-``(N)`` in this tree and records each
run's reboots.  Writes one JSON with the card's ``nvidia-smi`` name and
power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 300
ORDER = ("other", "this", "this", "other")    # parent and change in turns

# The child: one tree's package, the three sequences (or mh01-like under
# other seeds), one JSON line a run.
CHILD = r"""
import contextlib, json, statistics, sys, time
import torch
from tinyslam_tpu_torch import eval_ate
from tinyslam_tpu_torch.models import slam as sm
from tinyslam_tpu_torch.utils.draws import Sampler

roots, frames, seeds, only = (json.loads(sys.argv[1]), int(sys.argv[2]),
                              json.loads(sys.argv[3]), sys.argv[4])
stages = ("kf_ingest", "loop_probe", "graph_solve", "solve_capture")
calls = {}
real = sm.Slam._timed

@contextlib.contextmanager
def timed(self, key):
    if key not in stages:
        with real(self, key):
            yield
        return
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    with real(self, key):
        yield
    b.record()
    calls.setdefault(key, []).append((time.perf_counter() - t0, a, b))

sm.Slam._timed = timed
names = {"fr1": "fr1_desk_like", "fr1_loop": "fr1_loop_like", "mh01": "mh01_like"}
for key, name in names.items():
    if only not in ("all", key):
        continue
    spec = eval_ate.SPECS[key](frames)
    for seed in seeds:
        calls.clear()
        out = eval_ate.run_sequence(name, spec["kind"], roots[name], "slam", "device",
                                    device="cuda", sampler=Sampler(seed))
        torch.cuda.synchronize()
        per = {}
        for k, v in calls.items():
            wall = [1e3 * w for w, _, _ in v]
            stream = [a.elapsed_time(b) for _, a, b in v]
            per[k] = {"calls": len(v), "wall_ms_median": statistics.median(wall),
                      "wall_ms_min": min(wall), "wall_ms_max": max(wall),
                      "wall_ms_first": wall[0],
                      "stream_ms_median": statistics.median(stream),
                      "stream_ms_min": min(stream), "stream_ms_max": max(stream)}
        out.pop("loop_log_tail", None)
        print("STAGE_EVAL " + json.dumps({"seed": seed, **out, "stages": per}), flush=True)
"""


def _render(frames: int) -> dict[str, str]:
    """The three sequences' directories, rendered by this tree's builders
    into the eval's cache where they are not there yet."""
    sys.path.insert(0, str(ROOT))
    from tinyslam_tpu_torch import eval_ate

    roots = {}
    for key, name in eval_ate.SEQUENCES.items():
        root, secs = eval_ate.dataset_sequence(eval_ate.SPECS[key](frames))
        roots[name] = str(root)
        print(f"{name}: {root.name} ({f'rendered in {secs:.1f} s' if secs else 'reused'})",
              flush=True)
    return roots


def _run(tree: Path, roots: dict, frames: int, seeds: list[int], only: str) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(roots), str(frames),
                           json.dumps(seeds), only], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=3000)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return [json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
            if line.startswith("STAGE_EVAL ")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other tree's root")
    ap.add_argument("--seeds-mh01", type=int, default=0)
    ap.add_argument("--out", default="EVAL_torch_pr16.json")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    roots = _render(FRAMES)
    trees = {"this": ROOT, "other": Path(args.other).resolve()}
    runs = []
    for i, which in enumerate(ORDER):
        t0 = time.perf_counter()
        results = _run(trees[which], roots, FRAMES, [0], "all")
        runs.append({"tree": which, "root": os.path.relpath(trees[which], ROOT), "turn": i,
                     "seconds": round(time.perf_counter() - t0, 1), "results": results})
        for r in results:
            per = {k: (v["calls"], round(v["wall_ms_median"], 2),
                       round(v["stream_ms_median"], 2)) for k, v in r["stages"].items()}
            print(f"{which} turn {i} {r['sequence']}: steady_fps {r['steady_fps']}, "
                  f"stage_budget_s {r['stage_budget_s']}, tracked {r['tracked']}, closures "
                  f"{r['loop_closures']}, ATE {r['ate_rmse_m']}; per call (calls, wall ms, "
                  f"stream ms) {per}", flush=True)
    reboots = None
    if args.seeds_mh01:
        extra = _run(ROOT, roots, FRAMES, list(range(1, args.seeds_mh01 + 1)), "mh01")
        first = next(r for run in runs if run["tree"] == "this" for r in run["results"]
                     if r["sequence"] == "mh01_like")
        reboots = {"seeds": [0] + [r["seed"] for r in extra],
                   "reboots": [first["reboots"]] + [r["reboots"] for r in extra],
                   "tracked": [first["tracked"]] + [r["tracked"] for r in extra],
                   "ate_rmse_m": [first["ate_rmse_m"]] + [r["ate_rmse_m"] for r in extra]}
        print(f"mh01-like under Sampler(0)-({args.seeds_mh01}): reboots {reboots['reboots']}, "
              f"tracked {reboots['tracked']}", flush=True)
    Path(args.out).write_text(json.dumps({
        "nvidia_smi": smi, "frames": FRAMES, "order": ",".join(ORDER), "runs": runs,
        "mh01_reboots": reboots,
        "note": ("wall ms: host clock around a stage's call (the solve's includes applying "
                 "the correction); stream ms: CUDA events on the current stream around it")},
        indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
