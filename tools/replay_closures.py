#!/usr/bin/env python3
"""Replay fr1_loop-like's loop closures through the port and the JAX package.

    python tools/replay_closures.py --card [--samplers 12] [--repeats 2]
        [--frames 300] [--out REPLAY_torch.json]
    python tools/replay_closures.py --card --order-check --compare REPLAY_torch.json
    python tools/replay_closures.py --reference REPLAY_torch.json [--out REPLAY_jaxcpu.json]

``--card`` runs the port on the card: ``eval_ate.run_sequence("fr1_loop_like",
..., "slam", "device", sampler=Sampler(s))`` for s = 0 .. samplers - 1 on the
300-frame sequence (rendered into ``build/tinyslam_tpu_torch/seq/`` once),
each ``--repeats`` times.  It catches every pose-graph solve by wrapping
``DeviceSlam._apply_graph_result`` (the library is unchanged) and records,
for each (a solve follows every accepted closure): the accepted candidate,
the snapshot ``Slam._optimize_graph`` builds (keyframe poses and the edge
list (i, j, R, t, s, w)), the solved Sim(3) nodes, the keyframe -> frame
map, the raw per-frame trajectory so far, the corrected camera centres
after the correction, and the first tracked frame; beside them the run's
summary and its final raw and corrected centres.  Arrays are stored
exactly (base64 of their bytes).  The repeats of a sampler must agree bit
for bit; the output says whether they do.  The ground truth of the
sequence goes into the output too.

``--order-check`` (run it in a process of its own, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in its environment) runs
``Sampler(0)`` once with PyTorch's deterministic-algorithm check in warn
mode and lists every operation that warned (the message and the line of
the port that called it); ``--compare FILE`` adds the list to FILE under
``order_check`` with whether the run's records equal FILE's ``Sampler(0)``
records bit for bit (ops that PyTorch switches to a deterministic
implementation in that mode do not warn: if they mattered, the records
would differ).

``--reference FILE`` runs here, on the CPU, with the JAX package: for every
recorded closure it solves the snapshot with the JAX package's
``Slam._solve_graph`` (on a stand-in carrying the JAX ``SlamConfig()``) and
with the port's ``solve_graph`` on the CPU, applies each solution with its
package's ``_extend_solution`` and ``corrected_trajectory`` arithmetic (on
stand-ins with the recorded trajectory, keyframe map and tables), and
reports the largest |dR|, |dt|, |ds| between the card's, the port's CPU and
the reference's solutions, the Sim(3)-aligned ATE (the JAX package's
``ate_rmse``, from the first tracked frame) of the raw trajectory, of the
trajectory before the solve and of the three corrected ones, and whether
each correction raised or lowered ATE against the trajectory before the
solve.  The ground truth is the recorded one, held against the JAX
builder's poses (``tools/eval_ate.py:build_fr1_loop_like``'s draws,
without rendering) within 1e-4 m.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import hashlib
import json
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEQUENCE = "fr1_loop_like"


def enc(a) -> dict:
    """An array, exactly: dtype, shape and its bytes in base64."""
    a = np.ascontiguousarray(np.asarray(a))
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode()}


def dec(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]), dtype=d["dtype"]).reshape(d["shape"])


def _first_tracked(stats) -> int:
    return next((i for i, s in enumerate(stats) if s.tracking), 0)


def _trajectory(traj) -> tuple[np.ndarray, np.ndarray]:
    return np.stack([np.asarray(R) for R, _ in traj]), np.stack([np.asarray(t) for _, t in traj])


class ClosureRecorder:
    """A context manager that records every pose-graph solve of every
    ``DeviceSlam`` (``models/slam.py``) applied inside it, in ``records``,
    and puts the real method back on exit."""

    def __init__(self):
        self.records: list[dict] = []

    def __enter__(self):
        from tinyslam_tpu_torch.models import slam as sm

        self._cls, self._real = sm.DeviceSlam, sm.DeviceSlam._apply_graph_result
        real, records = self._real, self.records

        def apply(slam, snap, solved):
            R_old, t_old, edges = snap
            n_total = len(slam.kf_R)
            real(slam, snap, solved)
            raw_R, raw_t = _trajectory(slam.vo.trajectory)
            accepted = [r for r in slam.loop_log if r["accepted"]]
            records.append({
                "frames": len(raw_R), "first": _first_tracked(slam.vo.stats),
                "keyframes": n_total,
                "closure": dict(accepted[-1]) if accepted else None,
                "kf_R": enc(R_old), "kf_t": enc(t_old),
                "edges": {"i": [int(e[0]) for e in edges], "j": [int(e[1]) for e in edges],
                          "R": enc(np.stack([e[2] for e in edges])),
                          "t": enc(np.stack([e[3] for e in edges])),
                          "s": [float(e[4]) for e in edges], "w": [float(e[5]) for e in edges]},
                "solved": {"R": enc(solved[0]), "t": enc(solved[1]), "s": enc(solved[2])},
                "kf_frame_of": {str(k): int(f) for k, f in slam.kf_frame_of.items()},
                "raw_R": enc(raw_R), "raw_t": enc(raw_t),
                "corrected": enc(slam.positions)})

        self._cls._apply_graph_result = apply
        return self

    def __exit__(self, *exc):
        self._cls._apply_graph_result = self._real
        return False


def snapshot(rec: dict):
    """The recorded snapshot as ``Slam._optimize_graph`` built it."""
    e = rec["edges"]
    edges = [(i, j, R, t, s, w) for i, j, R, t, s, w in
             zip(e["i"], e["j"], dec(e["R"]), dec(e["t"]), e["s"], e["w"])]
    return dec(rec["kf_R"]), dec(rec["kf_t"]), edges


def digest(x) -> str:
    return hashlib.sha256(json.dumps(x, sort_keys=True).encode()).hexdigest()


# ---------------- on the card ----------------
def _run(root, dev, seed: int, frames: int | None) -> dict:
    from tinyslam_tpu_torch import eval_ate
    from tinyslam_tpu_torch.utils.draws import Sampler

    made, real = [], eval_ate.DeviceSlam
    eval_ate.DeviceSlam = lambda *a, **kw: made.append(real(*a, **kw)) or made[-1]
    try:
        with ClosureRecorder() as rec:
            out = eval_ate.run_sequence(SEQUENCE, "tum", root, "slam", "device", device=dev,
                                        sampler=Sampler(seed), frames=frames)
    finally:
        eval_ate.DeviceSlam = real
    slam = made[-1]
    keys = ("frames", "tracked", "keyframes", "loop_closures", "reboots", "ate_rmse_m",
            "ate_se3_m", "ate_raw_m")
    return {"sampler": seed, "summary": {k: out[k] for k in keys},
            "first": _first_tracked(slam.vo.stats), "closures": rec.records,
            "final": {"positions": enc(slam.positions),
                      "raw_positions": enc(slam.raw_positions)}}


def _sequence(frames: int):
    from tinyslam_tpu_torch import eval_ate
    from tinyslam_tpu_torch.data.tum import TumSequence

    root, secs = eval_ate.dataset_sequence(eval_ate.fr1_loop_spec(frames))
    print(f"{SEQUENCE}: {frames} frames in {root.name} "
          f"({f'rendered in {secs:.1f} s' if secs else 'reused'})", flush=True)
    return root, TumSequence.open(root).gt_positions()


def card(args) -> None:
    import torch

    from tinyslam_tpu_torch.eval_ate import nvidia_smi

    if not torch.cuda.is_available():
        raise SystemExit("replay_closures --card: needs a CUDA device")
    dev, smi = torch.device("cuda"), nvidia_smi()
    root, gt = _sequence(args.frames)
    runs = []
    for seed in range(args.samplers):
        reps = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            reps.append(_run(root, dev, seed, args.frames))
            s = reps[-1]["summary"]
            print(f"Sampler({seed}): {time.perf_counter() - t0:.1f} s, {s['loop_closures']} "
                  f"closures, {len(reps[-1]['closures'])} solves, ATE {s['ate_rmse_m']} "
                  f"(raw {s['ate_raw_m']}), digest {digest(reps[-1])[:16]}  [{smi}]",
                  flush=True)
        run = reps[0]
        run["repeat_digests"] = [digest(r) for r in reps]
        run["repeats_bit_equal"] = len(set(run["repeat_digests"])) == 1
        runs.append(run)
    out = {"tool": "tools/replay_closures.py --card", "sequence": SEQUENCE,
           "frames": args.frames, "device": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "repeats": args.repeats, "gt": enc(gt), "runs": runs}
    equal = sum(r["repeats_bit_equal"] for r in runs)
    print(f"repeats bit-equal under {equal} of {len(runs)} samplers; "
          f"{sum(len(r['closures']) for r in runs)} solves recorded  [{smi}]")
    args.out.write_text(json.dumps(out))


def order_check(args) -> None:
    import torch

    from tinyslam_tpu_torch.eval_ate import nvidia_smi

    if not torch.cuda.is_available():
        raise SystemExit("replay_closures --order-check: needs a CUDA device")
    root, _ = _sequence(args.frames)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run = _run(root, torch.device("cuda"), 0, args.frames)
    torch.use_deterministic_algorithms(False)
    ops: dict[tuple[str, str], int] = {}
    pkg = str(ROOT / "tinyslam_tpu_torch")
    for w in caught:
        msg = str(w.message)
        if "deterministic" not in msg:
            continue
        where = f"{Path(w.filename).relative_to(ROOT)}:{w.lineno}" \
            if w.filename.startswith(pkg) else f"{w.filename}:{w.lineno}"
        key = (msg.splitlines()[0], where)
        ops[key] = ops.get(key, 0) + 1
    result = {"warned": [{"message": m, "at": a, "count": c} for (m, a), c in ops.items()],
              "device": nvidia_smi(), "records_digest": digest(run)}
    for item in result["warned"]:
        print(f"warned {item['count']}x at {item['at']}: {item['message']}")
    if args.compare is not None:
        dump = json.loads(args.compare.read_text())
        ref = next(r for r in dump["runs"] if r["sampler"] == 0)
        result["equal_to_sampler0_records"] = digest(run) == ref["repeat_digests"][0]
        dump["order_check"] = result
        args.compare.write_text(json.dumps(dump))
        print(f"records under the deterministic check equal the default runs': "
              f"{result['equal_to_sampler0_records']}")


# ---------------- the reference, on the CPU ----------------
def _corrected(corrected_trajectory, traj, kf_frame_of, R_se, t_se) -> np.ndarray:
    """Camera centres of ``corrected_trajectory`` (a package's method) on a
    stand-in with the recorded trajectory and keyframe map and the given
    keyframe tables."""
    stand_in = types.SimpleNamespace(vo=types.SimpleNamespace(trajectory=traj),
                                     kf_frame_of=kf_frame_of, kf_R=list(R_se), kf_t=list(t_se))
    return np.asarray([-R.T @ t for R, t in corrected_trajectory(stand_in)])


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def replay(rec: dict, gt: np.ndarray, jax_cfg=None, torch_cfg=None) -> dict:
    """One recorded closure solved and applied by the card (as recorded),
    the port on the CPU and the JAX package (under ``jax_cfg`` and
    ``torch_cfg``, default ``SlamConfig()`` each); their differences and
    ATEs."""
    from tinyslam_tpu.config import SlamConfig as JaxSlamConfig
    from tinyslam_tpu.models import slam as jslam
    from tinyslam_tpu.utils.evaluation import ate_rmse
    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.models import slam as tslam

    snap = snapshot(rec)
    solved = {"card": tuple(dec(rec["solved"][k]) for k in "Rts"),
              "port_cpu": tslam.unpack_solve(tslam.solve_graph(
                  torch_cfg or SlamConfig(), snap, "cpu")),
              "reference": tuple(np.asarray(x) for x in jslam.Slam._solve_graph(
                  types.SimpleNamespace(cfg=jax_cfg or JaxSlamConfig()), snap))}
    traj = list(zip(dec(rec["raw_R"]), dec(rec["raw_t"])))
    kf_map = {int(k): f for k, f in rec["kf_frame_of"].items()}
    kf_R, kf_t = list(snap[0]), list(snap[1])
    first, m = rec["first"], rec["frames"]

    def ate(pos):
        return float(ate_rmse(pos[first:m], gt[first:m]))

    centres = {"raw": np.asarray([-R.T @ t for R, t in traj]),
               "before": _corrected(jslam.Slam.corrected_trajectory, traj, kf_map, kf_R, kf_t),
               "card": dec(rec["corrected"])[:m]}
    for name, cls in (("port_cpu", tslam.Slam), ("reference", jslam.Slam)):
        R_se, t_se = cls._extend_solution(snap, solved[name], kf_R, kf_t)[5:7]
        centres[name] = _corrected(cls.corrected_trajectory, traj, kf_map,
                                   np.asarray(R_se), np.asarray(t_se))
    # The card's solution through the reference's arithmetic: the
    # correction's share of any difference, apart from the solve's.
    R_se, t_se = jslam.Slam._extend_solution(snap, solved["card"], kf_R, kf_t)[5:7]
    centres["card_solve_reference_correction"] = _corrected(
        jslam.Slam.corrected_trajectory, traj, kf_map, np.asarray(R_se), np.asarray(t_se))
    ates = {k: ate(v) for k, v in centres.items()}
    pairs = (("card", "port_cpu"), ("card", "reference"), ("port_cpu", "reference"))
    diffs = {f"{a}-{b}": {"R": _max_diff(solved[a][0], solved[b][0]),
                          "t": _max_diff(solved[a][1], solved[b][1]),
                          "s": _max_diff(solved[a][2], solved[b][2])} for a, b in pairs}
    sign = {k: "raised" if ates[k] > ates["before"] else "lowered"
            for k in ("card", "port_cpu", "reference")}
    c = rec["closure"] or {}
    return {"frame": m, "keyframes": rec["keyframes"], "nodes": len(snap[0]),
            "edges": len(snap[2]), "closure": {k: c.get(k) for k in (
                "kf", "old", "num_inliers", "n_chain", "rmse", "s_e", "n_scale_pairs")},
            "solve_diff": diffs, "ate_sim3_m": ates, "correction": sign,
            "card_reproduced_on_cpu": _max_diff(centres["card"], centres["port_cpu"]),
            "signs_agree": len(set(sign.values())) == 1,
            "ate_card_vs_reference_m": abs(ates["card"] - ates["reference"])}


def _jax_builder_centres(frames: int) -> np.ndarray:
    """Camera centres of the JAX tool's fr1_loop-like poses (its draws up to
    the trajectory; nothing rendered)."""
    from tinyslam_tpu.data.synthetic import TexturedRoom, handheld_trajectory

    rng = np.random.default_rng(303)
    TexturedRoom(rng, tex_res=256, octaves=4, clutter=10)
    poses = handheld_trajectory(rng, frames, step=(2.0 * np.pi + 0.35) / frames,
                                jitter_pos=0.003, jitter_tgt=0.008)
    return np.asarray([-np.asarray(R).T @ np.asarray(t) for R, t in poses])


def reference(args) -> None:
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        import flax.struct  # noqa: F401
    except ImportError:
        sys.path.insert(0, str(ROOT / "tools"))
        from jax_reference_orbit import _flax_stand_in

        _flax_stand_in()
    dump = json.loads(args.reference.read_text())
    gt = dec(dump["gt"])
    gt_err = _max_diff(gt, _jax_builder_centres(dump["frames"]))
    if gt_err > 1e-4:
        raise AssertionError(f"the recorded ground truth is {gt_err} m from the JAX builder's")
    runs = []
    for run in dump["runs"]:
        rows = [replay(rec, gt) for rec in run["closures"]]
        for r in rows:
            a = r["ate_sim3_m"]
            print(f"Sampler({run['sampler']}) frame {r['frame']} closure kf {r['closure']['kf']} "
                  f"-> {r['closure']['old']}: ATE raw {a['raw']:.4f} before {a['before']:.4f} "
                  f"card {a['card']:.4f} port-cpu {a['port_cpu']:.4f} reference "
                  f"{a['reference']:.4f}; {r['correction']}; |dt| card-ref "
                  f"{r['solve_diff']['card-reference']['t']:.2e}", flush=True)
        runs.append({"sampler": run["sampler"], "summary": run["summary"],
                     "repeats_bit_equal": run["repeats_bit_equal"], "closures": rows})
    rows = [r for run in runs for r in run["closures"]]
    verdict = {
        "closures": len(rows),
        "signs_agree": sum(r["signs_agree"] for r in rows),
        "within_1e-3_m": sum(r["ate_card_vs_reference_m"] <= 1e-3 for r in rows),
        "card_raised": sum(r["correction"]["card"] == "raised" for r in rows),
        "reference_raised": sum(r["correction"]["reference"] == "raised" for r in rows),
        "max_ate_card_vs_reference_m": max((r["ate_card_vs_reference_m"] for r in rows),
                                           default=None),
        "traced": all(r["signs_agree"] and r["ate_card_vs_reference_m"] <= 1e-3 for r in rows),
    }
    out = {"tool": "tools/replay_closures.py --reference", "card_dump": args.reference.name,
           "card_device": dump["device"], "gt_vs_jax_builder_m": gt_err,
           "jax": jax.__version__, "runs": runs, "verdict": verdict}
    print(json.dumps(verdict))
    args.out.write_text(json.dumps(out, indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--card", action="store_true", help="run the port on the card")
    mode.add_argument("--reference", type=Path, metavar="FILE",
                      help="replay FILE's closures through both packages on the CPU")
    ap.add_argument("--order-check", action="store_true",
                    help="with --card: Sampler(0) under the deterministic-algorithm check")
    ap.add_argument("--compare", type=Path, default=None,
                    help="with --order-check: the --card output to compare with and extend")
    ap.add_argument("--samplers", type=int, default=12)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.card:
        if args.order_check:
            return order_check(args)
        args.out = args.out or Path("REPLAY_torch.json")
        return card(args)
    args.out = args.out or Path("REPLAY_jaxcpu.json")
    with contextlib.suppress(BrokenPipeError):
        reference(args)


if __name__ == "__main__":
    main()
