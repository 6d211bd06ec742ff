#!/usr/bin/env python3
"""Trace where the port's CUDA path and its CPU plain path part.

Runs one tracker on the card and the same tracker on the CPU, frame by
frame in lockstep, on identical frames and identical RANSAC draws (two
``Sampler`` objects of one seed), and after every frame compares, in
pipeline order: the pyramid levels, the five maps of the fused FAST stage
per level (raw and NMS scores, moments, blurred level), the top-k
selection (xy, angle, score, valid), the descriptors, the two-view
estimate of a bootstrap attempt, the frame's summary counts, the pose,
the map (valid set, then points) and the window poses.  It prints the
first frame and the first quantity that differ, with the largest
difference, and the frames where the camera centres first part by more
than 1e-6, 1e-4 and 1e-2 m.

    python tools/trace_card_cpu.py [--root DIR] [--case boot160|phase6|slamhost|all]
        [--frames N] [--out FILE]
    python tools/trace_card_cpu.py --case eval --ref ref.json [--out FILE]

- ``boot160``: ``DeviceVO`` from frame 0 of the 160x120 orbit of
  ``tests/torch_parity.py`` (2 levels x 128 features, 512 map points,
  keyframes on), sampler seeds 0-7, 16 frames: the host-phase bootstrap.
- ``phase6``: ``chip_smoke.py`` phase 6, the default ``SlamConfig()`` at
  640x480 from the seeded map of frame 0, ``track_step`` on frames 1..N-1
  (default 189); ``--out`` also keeps each frame's summary row and
  centre error on both devices, to set beside
  ``tools/jax_reference_orbit.py --frames N --out``.
- ``slamhost``: the host ``Slam`` over the out-and-back of the 160x120
  orbit (frames 0-21, then 20-0; ``loop_min_gap`` 3), as
  ``tests/test_torch_slam_host.py`` runs it.
- ``chain``: grayscale of RGB (uint8 and float), downsample and blur at
  160x120, card against CPU (always run first).
- ``eval``: the port's ``eval_ate.run_sequence`` on the card against the
  JAX reference's run of the same sequence and mode (``--ref FILE``,
  written by ``tools/jax_reference_orbit.py --eval NAME --out FILE``), on
  the same files and with the reference's draws
  (``torch_parity.JaxSampler`` at the reference's key offset, any offset):
  the first frame whose tracking or keyframe flag or counts (features,
  matches, inliers, landmarks) differ, the frames where the raw camera
  centres part by more than 1e-6, 1e-4 and 1e-2 m, and both runs' reboot
  frames; in ``slam`` mode, with a reference that records its loop log,
  every loop candidate side by side (keyframes, decision, inliers,
  ``s_e``), the first that differs and the largest relative ``s_e``
  difference of the accepted ones.  Needs ``jax`` for the draws.

``--root`` imports ``tinyslam_tpu_torch`` from another tree (a parent
commit unpacked with ``git archive``), to trace it with this script.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

WIDTH, HEIGHT = 160, 120
CAMERA = dict(fx=130.0, fy=130.0, cx=79.5, cy=59.5)
MAP_FIELDS = ("valid", "X", "desc", "anchor_kf", "obs_count", "last_seen")


def _np(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _diff(a, b) -> float | None:
    """None if equal (NaN equal to NaN), else the largest difference."""
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        return float("inf")
    if a.dtype == bool or not np.issubdtype(a.dtype, np.floating):
        return None if np.array_equal(a, b) else float((a != b).sum())
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    if same.all():
        return None
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float(np.nanmax(np.where(same, 0.0, np.nan_to_num(d, nan=np.inf))))


class Recorder:
    """Wraps the front-end's FAST stage and extraction and the two-view
    estimate of one package, recording each call's outputs in order; a
    context manager that puts the real functions back on exit."""

    def __init__(self):
        from tinyslam_tpu_torch.frontend import orb
        from tinyslam_tpu_torch.models import two_view, vo_device

        self.calls: list[tuple[str, dict]] = []
        real_maps = orb.fast_pyramid_maps
        real_extract = orb.extract_features
        real_estimate = two_view.TwoViewEstimator.estimate
        self._restore = [(orb, "fast_pyramid_maps", real_maps),
                         (orb, "extract_features", real_extract),
                         (vo_device, "extract_features", vo_device.extract_features),
                         (two_view.TwoViewEstimator, "estimate", real_estimate)]

        def maps(levels, *a, **kw):
            out = real_maps(levels, *a, **kw)
            rec = {}
            for i, (lvl, m) in enumerate(zip(levels, out)):
                rec[f"level{i}"] = lvl
                for name, x in zip(("score_raw", "score_nms", "m10", "m01", "blurred"), m):
                    rec[f"level{i}.{name}"] = x
            self.calls.append(("fast", rec))
            return out

        def extract(*a, **kw):
            f = real_extract(*a, **kw)
            self.calls.append(("features", {k: getattr(f, k) for k in
                                            ("xy", "angle", "score", "valid", "level", "desc")}))
            return f

        def estimate(est, fa, fb, sampler, seed=0):
            out = real_estimate(est, fa, fb, sampler, seed)
            self.calls.append(("two_view", {k: out[k] for k in (
                "match_valid", "matches", "inliers", "num_inliers", "R", "t", "points")}
                | {"model": np.asarray(out["model"] == "E")}))
            return out

        orb.fast_pyramid_maps = maps
        orb.extract_features = extract
        vo_device.extract_features = extract
        two_view.TwoViewEstimator.estimate = estimate

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._restore:
            setattr(owner, name, fn)

    def take(self) -> list[tuple[str, dict]]:
        out, self.calls = self.calls, []
        return out


def compare_calls(card, cpu) -> tuple[str, float] | None:
    """The first differing quantity of two frames' call records."""
    for (kind_a, a), (kind_b, b) in zip(card, cpu):
        if kind_a != kind_b:
            return f"call order {kind_a} vs {kind_b}", float("inf")
        for k in a:
            d = _diff(a[k], b[k])
            if d is not None:
                return f"{kind_a}.{k}", d
    if len(card) != len(cpu):
        return "number of calls", float(abs(len(card) - len(cpu)))
    return None


def compare_state(card: dict, cpu: dict) -> tuple[str, float] | None:
    for k in card:
        d = _diff(card[k], cpu[k])
        if d is not None:
            return k, d
    return None


def _centre(R, t):
    R, t = _np(R).astype(np.float64), _np(t).astype(np.float64)
    return -R.T @ t


def _decisions(calls, state) -> list:
    """The discrete outcomes of a frame: two-view inlier counts and model,
    the summary counts, whether the tracker has bootstrapped."""
    out = [(f"two_view.{k}", _np(d[k]).tolist()) for kind, d in calls if kind == "two_view"
           for k in ("num_inliers", "model")]
    return out + [(k, _np(state[k]).tolist()) for k in ("summary", "bootstrapped")
                  if k in state]


class Trace:
    """Collects the per-frame verdicts of one lockstep run."""

    def __init__(self, name):
        self.name = name
        self.first = None            # (frame, quantity, diff)
        self.decision = None         # (frame, card's outcomes, CPU's)
        self.parted = {}             # threshold -> first frame
        self.rows = []

    def frame(self, i, calls, state, centres):
        q = compare_calls(*calls) or compare_state(*state)
        dc = float(np.linalg.norm(centres[0] - centres[1]))
        self.rows.append({"frame": i, "first": q and [q[0], q[1]], "centre_diff": dc})
        if q and self.first is None:
            self.first = (i, q[0], q[1])
        card, cpu = (_decisions(c, s) for c, s in zip(calls, state))
        if card != cpu and self.decision is None:
            self.decision = (i, card, cpu)
        for th in (1e-6, 1e-4, 1e-2):
            if dc > th and th not in self.parted:
                self.parted[th] = i

    def summary(self) -> dict:
        return {"case": self.name, "first_difference": self.first,
                "first_decision": self.decision,
                "centres_part": {f"{k:g}": v for k, v in self.parted.items()},
                "frames": len(self.rows)}


def chain_check(dev) -> dict:
    import torch

    from tinyslam_tpu_torch.ops.image import build_pyramid, gaussian_blur, rgb_to_gray

    rng = np.random.default_rng(0)
    rgb8 = rng.integers(0, 256, (HEIGHT, WIDTH, 3), np.uint8)
    out = {}
    for name, img in (("rgb_uint8", rgb8), ("rgb_float", rgb8.astype(np.float32) / 255.0)):
        g_card = rgb_to_gray(torch.from_numpy(img).to(dev))
        g_cpu = rgb_to_gray(torch.from_numpy(img))
        out[f"gray {name}"] = _diff(g_card, g_cpu)
    gray = rng.random((HEIGHT, WIDTH)).astype(np.float32)
    for i, (a, b) in enumerate(zip(build_pyramid(torch.from_numpy(gray).to(dev), 3),
                                   build_pyramid(torch.from_numpy(gray), 3))):
        out[f"level{i}"] = _diff(a, b)
        out[f"blur level{i}"] = _diff(gaussian_blur(a), gaussian_blur(b))
    u8 = torch.from_numpy(rgb8[..., 0])
    out["uint8 -> float"] = _diff(u8.to(dev).to(torch.float32) * (1.0 / 255.0),
                                  u8.to(torch.float32) * (1.0 / 255.0))
    return out


def _orbit(n, width, height, cam_kw):
    from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera

    cam = PinholeCamera.create(**cam_kw)
    room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
    poses = orbit_trajectory(n, radius=2.0, step=0.02, start=-0.35, target=(0.0, 0.0, 2.0))
    return cam, room, poses, [room.render(cam, R, t, width, height) for R, t in poses]


def _small_config():
    from tinyslam_tpu_torch import config as tc

    return tc.SlamConfig(frontend=tc.FrontendConfig(height=HEIGHT, width=WIDTH, num_levels=2,
                                                    features_per_level=128),
                         vo=tc.VOConfig(max_map_points=512))


def _host_state(vo) -> dict:
    out = {"pose.R": vo.R, "pose.t": vo.t}
    out.update({f"map.{k}": getattr(vo.map, k) for k in MAP_FIELDS})
    out.update({"window.R": vo.win_R, "window.t": vo.win_t})
    return out


def _stat_row(st) -> dict:
    return {"summary": np.array([st.tracking, st.is_keyframe, st.num_features,
                                 st.num_matches, st.num_inliers, st.num_landmarks])}


def case_boot160(dev, rec, frames_n=16, seeds=range(8)) -> list[dict]:
    from tinyslam_tpu_torch.models.vo_device import DeviceVO
    from tinyslam_tpu_torch.utils.draws import Sampler

    cam, _, _, frames = _orbit(frames_n, WIDTH, HEIGHT, CAMERA)
    cfg = _small_config()
    out = []
    for seed in seeds:
        tr = Trace(f"boot160 seed {seed}")
        vos = [DeviceVO(cfg, cam, chunk=4, device=d, sampler=Sampler(seed))
               for d in (dev, "cpu")]
        for i, f in enumerate(frames):
            calls, states, centres = [], [], []
            for vo in vos:
                rec.take()
                vo.process(f)
                vo.flush()
                calls.append(rec.take())
                st = vo.stats[-1]
                s = _stat_row(st) | {"bootstrapped": np.array(vo.initialized)}
                if vo.state is not None:
                    s |= {"pose.R": vo.state.R, "pose.t": vo.state.t}
                states.append(s)
                centres.append(_centre(*vo.trajectory[-1]))
            tr.frame(i, calls, states, centres)
        s = tr.summary()
        s["bootstrap_frame"] = [vo.host_frames - 1 if vo.initialized else None for vo in vos]
        out.append(s)
    return out


def case_phase6(dev, rec, n=189) -> list[dict]:
    import torch

    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.models.vo_device import SUMMARY_FIELDS, VOState
    from tinyslam_tpu_torch.utils.draws import Sampler

    cam_kw = dict(fx=520.0, fy=520.0, cx=640 / 2 - 0.5, cy=480 / 2 - 0.5)
    cam, room, poses, frames = _orbit(n, 640, 480, cam_kw)
    cfg = SlamConfig()
    feats0 = extract_features(torch.from_numpy(frames[0]), cfg.frontend.threshold, cfg.frontend)
    xy = feats0.xy[feats0.valid].numpy().astype(np.float64)
    X = torch.from_numpy(room.raycast(cam, *poses[0], xy).astype(np.float32))
    seed = VOState.seeded(cfg, feats0, X, *(torch.from_numpy(np.asarray(a)) for a in poses[0]))
    states = [VOState.from_numpy(seed.to_numpy(), d) for d in (dev, "cpu")]
    samplers = [Sampler(0), Sampler(0)]
    tr = Trace("phase6")
    per_frame = []               # (frame, summary card, summary CPU, error card, error CPU)
    t0 = time.perf_counter()
    for i in range(1, n):
        calls, rows, centres = [], [], []
        for k, d in enumerate((dev, "cpu")):
            rec.take()
            states[k], ys = vd.track_step(cam, cfg, states[k],
                                          torch.from_numpy(frames[i]).to(d), samplers[k])
            calls.append(rec.take())
            s = ys["summary"].cpu().numpy()
            st = states[k]
            row = {"summary": s[[SUMMARY_FIELDS.index(f) for f in SUMMARY_FIELDS
                                 if f not in ("rmse_px", "threshold")]],
                   "rmse_px": s[SUMMARY_FIELDS.index("rmse_px")],
                   "threshold": st.threshold, "pose.R": st.R, "pose.t": st.t}
            row |= {f"map.{f}": getattr(st.map, f) for f in MAP_FIELDS}
            row |= {"window.R": st.win_R, "window.t": st.win_t}
            rows.append(row)
            centres.append(_centre(st.R, st.t))
        tr.frame(i, calls, rows, centres)
        gt = _centre(*poses[i])
        per_frame.append([i] + [r["summary"].tolist() for r in rows]
                         + [float(np.linalg.norm(c - gt)) for c in centres])
    s = tr.summary()
    s["per_frame"] = per_frame
    s["seconds"] = time.perf_counter() - t0
    s["centre_diff_every_10"] = [round(r["centre_diff"], 9) for r in tr.rows[::10]]
    return [s]


def case_slamhost(dev, rec, n=None) -> list[dict]:
    from tinyslam_tpu_torch.models.slam import Slam
    from tinyslam_tpu_torch.utils.draws import Sampler

    cam, _, _, frames = _orbit(22, WIDTH, HEIGHT, CAMERA)
    frames = (frames + frames[-2::-1])[:n]
    cfg = _small_config()
    cfg = dataclasses.replace(cfg, pose_graph=dataclasses.replace(cfg.pose_graph,
                                                                  loop_min_gap=3))
    slams = [Slam(cfg, cam, device=d, sampler=Sampler(0)) for d in (dev, "cpu")]
    tr = Trace("slamhost")
    for i, f in enumerate(frames):
        calls, rows, centres = [], [], []
        for s in slams:
            rec.take()
            st = s.process_frame(f)
            calls.append(rec.take())
            rows.append(_stat_row(st) | _host_state(s.vo)
                        | {"kf_R": np.stack(s.kf_R) if s.kf_R else np.zeros(0),
                           "closures": np.array(s.num_loop_closures)})
            centres.append(_centre(*s.vo.trajectory[-1]))
        tr.frame(i, calls, rows, centres)
    for s in slams:
        s.finalize()
    return [tr.summary()]


def case_eval(dev, ref_path) -> list[dict]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    import torch_parity as P
    from tinyslam_tpu_torch import eval_ate

    ref = json.loads(Path(ref_path).read_text())
    name = {v: k for k, v in eval_ate.SEQUENCES.items()}[ref["sequence"]]
    spec = eval_ate.SPECS[name](ref["frames"])
    root, _ = eval_ate.dataset_sequence(spec)
    made, real = [], {k: getattr(eval_ate, k) for k in ("DeviceSlam", "DeviceVO")}
    for k, cls in real.items():
        setattr(eval_ate, k, lambda *a, _cls=cls, **kw: made.append(_cls(*a, **kw)) or made[-1])
    try:
        out = eval_ate.run_sequence(ref["sequence"], spec["kind"], root, ref["mode"], "device",
                                    device=dev,
                                    sampler=P.JaxSampler(ref.get("key_offset", 0)))
    finally:
        for k, cls in real.items():
            setattr(eval_ate, k, cls)
    system = made[-1]
    vo = system.vo if ref["mode"] == "slam" else system
    rows = [[int(s.tracking), int(s.is_keyframe), s.num_features, s.num_matches,
             s.num_inliers, s.num_landmarks] for s in vo.stats]
    centres = np.asarray(system.raw_positions if ref["mode"] == "slam" else vo.positions)
    names = ("tracking", "keyframe", "features", "matches", "inliers", "landmarks")
    first = None
    for i, (a, b) in enumerate(zip(rows, ref["per_frame"]["summary"])):
        bad = [f"{n} {x} vs {y}" for n, x, y in zip(names, a, b) if x != y]
        if bad:
            first = {"frame": i, "port vs reference": bad}
            break
    dc = np.linalg.norm(centres - np.asarray(ref["per_frame"]["centres"]), axis=1)
    part = {str(t): (int(np.flatnonzero(dc > t)[0]) if (dc > t).any() else None)
            for t in (1e-6, 1e-4, 1e-2)}
    keys = ("tracked", "reboots", "keyframes", "loop_closures", "ate_rmse_m", "ate_se3_m",
            "ate_raw_m", "rpe_trans_m", "rpe_rot_deg")
    res = {"case": f"eval {ref['sequence']} {ref['mode']}",
           "key_offset": ref.get("key_offset", 0),
           "port": {k: out[k] for k in keys}, "reference": {k: ref[k] for k in keys},
           "first_difference": first, "centres_part_at": part,
           "reboots": {"port": [int(e["frame"]) for e in vo.submap_events],
                       "reference": ref["per_frame"]["reboots"]},
           "per_frame": {"port": rows, "centre_diff": dc.tolist()}}
    print(f"eval {ref['sequence']} {ref['mode']}, port with the reference's draws: first "
          f"difference {first}; centres part by 1e-6/1e-4/1e-2 m at frames {part}; reboots "
          f"{res['reboots']}", flush=True)
    if ref["mode"] == "slam" and "loop_log" in ref["per_frame"]:
        res["loop"] = compare_loop_logs(system.loop_log, ref["per_frame"]["loop_log"])
        res["per_frame"]["loop_log"] = system.loop_log
        res["per_frame"]["kf_frame_of"] = {str(k): f for k, f in system.kf_frame_of.items()}
        for a, b in zip(system.loop_log, ref["per_frame"]["loop_log"]):
            print(f"  candidate kf {a['kf']} old {a['old']}: port accepted {a['accepted']} "
                  f"inliers {a['num_inliers']}/{a['n_chain']} s_e {a['s_e']:.5g} pairs "
                  f"{a['n_scale_pairs']}/{a['n_scale_new']}; reference kf {b['kf']} old "
                  f"{b['old']} accepted {b['accepted']} inliers {b['num_inliers']}/{b['n_chain']} "
                  f"s_e {b['s_e']:.5g} pairs {b['n_scale_pairs']}/{b['n_scale_new']}", flush=True)
        print(f"loop log: {json.dumps(res['loop'])}; ATE raw -> corrected: port "
              f"{out['ate_raw_m']} -> {out['ate_rmse_m']}, reference {ref['ate_raw_m']} -> "
              f"{ref['ate_rmse_m']}", flush=True)
    return [res]


LOOP_EQUAL = ("kf", "old", "accepted", "n_appear", "n_chain", "num_inliers", "n_scale_pairs")


def compare_loop_logs(port: list[dict], ref: list[dict], s_e_rel: float = 2e-3) -> dict:
    """The loop candidates of two runs side by side, in order: the first
    whose keyframes, decision or counts differ, and the largest relative
    difference of ``s_e`` over the accepted candidates both runs share
    (within ``s_e_rel``, phase 9b's tolerance, or not)."""
    first = None
    rel = []
    for i, (a, b) in enumerate(zip(port, ref)):
        bad = [f"{k} {a[k]} vs {b[k]}" for k in LOOP_EQUAL if a[k] != b[k]]
        if bad and first is None:
            first = {"candidate": i, "port vs reference": bad}
        if not bad and a["accepted"]:
            both_nan = np.isnan(a["s_e"]) and np.isnan(b["s_e"])
            rel.append(0.0 if both_nan else abs(a["s_e"] - b["s_e"]) / max(abs(b["s_e"]), 1e-12))
    if first is None and len(port) != len(ref):
        first = {"candidate": min(len(port), len(ref)),
                 "port vs reference": [f"candidates {len(port)} vs {len(ref)}"]}
    return {"candidates": [len(port), len(ref)],
            "accepted": [[(r["kf"], r["old"]) for r in log if r["accepted"]]
                         for log in (port, ref)],
            "first_difference": first,
            "accepted_s_e_max_rel": max(rel) if rel else None,
            "s_e_within": all(r <= s_e_rel for r in rel)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--case", default="all",
                    choices=("boot160", "phase6", "slamhost", "chain", "eval", "all"))
    ap.add_argument("--ref", help="with --case eval: tools/jax_reference_orbit.py --eval's "
                                  "--out file")
    ap.add_argument("--frames", type=int, default=189)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    else:
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_card_cpu: needs a CUDA device")
    torch.set_num_threads(8)
    import tinyslam_tpu_torch

    dev = torch.device("cuda")
    print(f"tinyslam_tpu_torch from {Path(tinyslam_tpu_torch.__file__).parent}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    result = {"root": str(Path(tinyslam_tpu_torch.__file__).parent.parent),
              "chain": chain_check(dev)}
    print("chain (None = bit-equal):", result["chain"], flush=True)
    if args.case == "eval":
        t0 = time.perf_counter()
        result["eval"] = case_eval(dev, args.ref)
        print(json.dumps({k: v for k, v in result["eval"][0].items() if k != "per_frame"}))
        print(f"eval: {time.perf_counter() - t0:.1f} s", flush=True)
    cases = (("boot160", "slamhost", "phase6") if args.case == "all"
             else () if args.case == "eval" else (args.case,))
    with Recorder() as rec:
        for case in cases:
            if case == "chain":
                continue
            t0 = time.perf_counter()
            if case == "phase6":
                res = case_phase6(dev, rec, args.frames)
            else:
                res = {"boot160": case_boot160, "slamhost": case_slamhost}[case](dev, rec)
            result[case] = res
            for r in res:
                print(json.dumps({k: v for k, v in r.items() if k != "per_frame"}), flush=True)
            print(f"{case}: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
