"""The JAX reference on chip_smoke.py's sequences.

Default mode: runs ``tinyslam_tpu``'s ``track_chunk`` (default
``SlamConfig()``, 640x480) on the CPU over the seeded bench orbit that
``chip_smoke.py`` phase 6 tracks with the PyTorch port: frame 0's features
at their ray-cast 3D points seed the map, frames 1..N-1 are tracked.
Prints one line per frame (summary row and camera-centre error against
ground truth) and the max error, which ``chip_smoke.REF_MAX_ERR`` holds.

``--bootstrap``: runs the JAX ``DeviceVO`` from frame 0 of the same orbit,
as phase 8 runs the port's: the host-phase two-view bootstrap, then
chunked tracking to frame N-1.  Prints the bootstrap frame and model, the
tracking flags, and the Sim(3)-aligned ATE over frames 14..N-1 (both
trackers must have bootstrapped by frame 14), which
``chip_smoke.REF_BOOT_ATE`` holds.

``--slam``: runs the JAX ``DeviceSlam`` from frame 0 over the out-and-back
of the orbit that phase 9 runs (frames 0..N-1, then N-2..0), under the
default ``SlamConfig()`` with ``pose_graph.loop_min_gap`` 6.  Prints the
keyframes, every loop candidate's decision, the accepted closures and the
Sim(3)-aligned ATE of the corrected trajectory from the bootstrap frame
on, which ``chip_smoke.REF_SLAM_ATE`` and ``REF_SLAM_CLOSURES`` hold.

``--bootstrap --kidnap``: the same DeviceVO with phase 8's forced
relocalization at frame 60 and its kidnap: from the state after frame 100,
relocalization forced, each frame 2, 4, ..., 20 orbit steps ahead is
tracked from that state.  Prints (tracked, inliers) for each jump, which
phase 8e's sweep prints for the port; then the port's ``track_step`` on
the CPU from the same state, with the reference's draws
(``torch_parity.JaxSampler``) and with ``Sampler(0)``, ``(1)``, ``(2)``.

``--tum [DIR]``, ``--euroc [DIR]``: the JAX ``DeviceSlam`` over the first
``--frames`` frames of a TUM or EuRoC sequence, as ``tinyslam_tpu.run``
runs it (the default ``SlamConfig()``, chunk 16, the dataset's
intrinsics, uint8 frames as float32 / 255, the ATE from the first tracked
frame).  The frames come through the port's loader, which gives the JAX
loader's frames exactly (tests/test_torch_data.py).  Without DIR, the
sequence is chip_smoke.py's phase 10 one, rendered first if it is not on
disk.  Prints tracked frames, keyframes, accepted closures, reboots and the
ATE.  With ``--prefix``, a run that reboots is repeated on the prefix
before the first reboot until one does not: phase 10's ``N_TUM`` and
``N_EUROC``.  ``--key-offset S`` adds 1000 S to every
``jax.random.PRNGKey`` seed the JAX package draws from (its RANSAC and
relocalization streams): the same run under other draws.  A bootstrap
on these sequences is a knife edge (its first attempts see a baseline of
a few centimetres), so one run is one sample: ``chip_smoke.REF_TUM_*`` and
``REF_EUROC_*`` hold the envelope of offsets 0-3 (the fewest tracked
frames, keyframes and closures, the largest ATE).

``--eval fr1|fr1_loop|mh01``: the JAX accuracy harness itself,
``tools/eval_ate.py``'s ``run_sequence`` (imported unchanged, ``--mode
slam|vo``, tracker ``device``), on that tool's sequence at ``--frames``
(default 300) as the port renders and caches it
(``tinyslam_tpu_torch.eval_ate.dataset_sequence``, the files equal to
the JAX tool's builders byte for byte), read by the JAX package's own
loader (a private build of its native sources under ``build/``).  Prints
and writes the JAX tool's JSON with ``key_offset`` and a per-frame record
added (``per_frame``: each frame's tracking and keyframe flags and counts,
the raw camera centres, the reboot frames and, in ``slam`` mode, every
loop candidate's record and the keyframes' frames; ``tools/trace_card_cpu.py
--case eval --ref`` compares the port's run with it):
``EVAL_jaxcpu_*.json`` and ``chip_smoke.REF_LOOP_*`` (fr1_loop, ``slam``,
offsets 0-3).  With ``--boot-sweep N``: the host tracker's first bootstrap
attempt on that sequence (frame 3 against frame 0), the JAX two-view
estimate against the port's on the CPU on each one's own features, under
the reference's draws at key offsets 0..N-1: inliers, median parallax,
whether it passes the bootstrap's gates and its translation's angle to
the ground truth's (about a minute).

    python tools/jax_reference_orbit.py --frames 189 [--out ref.json]
    python tools/jax_reference_orbit.py --bootstrap --frames 101
    python tools/jax_reference_orbit.py --bootstrap --kidnap
    python tools/jax_reference_orbit.py --slam --frames 101
    python tools/jax_reference_orbit.py --tum --frames 150 --prefix [--key-offset S]
    python tools/jax_reference_orbit.py --euroc --frames 60 --prefix [--key-offset S]
    python tools/jax_reference_orbit.py --eval fr1_loop [--mode slam|vo] [--frames 300]
        [--key-offset S] [--out ref.json]
    python tools/jax_reference_orbit.py --eval fr1_loop --boot-sweep 24 [--out sweep.json]

Full width takes about 3 minutes and a few GB on an 8-core CPU.  Where
``flax`` is not installed, a minimal stand-in for ``flax.struct`` (a frozen
dataclass registered as a pytree, all the JAX package uses of flax) is put
in its place.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _flax_stand_in() -> None:
    import jax

    def dataclass(cls):
        cls = dataclasses.dataclass(frozen=True)(cls)
        names = [f.name for f in dataclasses.fields(cls)]
        jax.tree_util.register_pytree_node(
            cls, lambda x: ([getattr(x, n) for n in names], None),
            lambda _, children: cls(*children))
        cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
        return cls

    struct = types.ModuleType("flax.struct")
    struct.dataclass = dataclass
    flax = types.ModuleType("flax")
    flax.struct = struct
    sys.modules.update({"flax": flax, "flax.struct": struct})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=None,
                    help="frames (default 189; 300 with --eval)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--bootstrap", action="store_true",
                    help="run DeviceVO from frame 0 instead of a seeded map")
    ap.add_argument("--slam", action="store_true",
                    help="run DeviceSlam from frame 0 over the out-and-back")
    ap.add_argument("--kidnap", action="store_true",
                    help="with --bootstrap: phase 8's forced relocalization and kidnap sweep")
    ap.add_argument("--tum", nargs="?", const="", default=None, metavar="DIR",
                    help="run DeviceSlam over a TUM sequence (default: phase 10's)")
    ap.add_argument("--euroc", nargs="?", const="", default=None, metavar="DIR",
                    help="run DeviceSlam over a EuRoC sequence (default: phase 10's)")
    ap.add_argument("--prefix", action="store_true",
                    help="with --tum/--euroc: shorten the run to the prefix before a reboot")
    ap.add_argument("--key-offset", type=int, default=0,
                    help="add 1000 x this to every jax.random.PRNGKey seed")
    ap.add_argument("--eval", choices=["fr1", "fr1_loop", "mh01"],
                    help="run tools/eval_ate.py's run_sequence on this sequence")
    ap.add_argument("--mode", choices=["slam", "vo"], default="slam",
                    help="with --eval: the harness's mode")
    ap.add_argument("--boot-sweep", type=int, default=0, metavar="N",
                    help="with --eval: the first bootstrap attempt under key offsets 0..N-1, "
                         "the JAX estimate against the port's")
    args = ap.parse_args()
    if args.frames is None:
        args.frames = 300 if args.eval else 189
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.key_offset:
        key = jax.random.PRNGKey
        jax.random.PRNGKey = lambda n, *a, **kw: key(n + 1000 * args.key_offset, *a, **kw)
    try:
        import flax.struct  # noqa: F401
    except ImportError:
        _flax_stand_in()
    import jax.numpy as jnp
    import torch

    import chip_smoke
    import torch_parity as P
    from tinyslam_tpu.config import SlamConfig as JaxSlamConfig
    from tinyslam_tpu.frontend.orb import extract_features
    from tinyslam_tpu.geometry.camera import PinholeCamera as JaxCamera
    from tinyslam_tpu.models.vo_device import track_chunk
    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models.vo_device import VOState
    from tinyslam_tpu_torch.types import Features

    jcfg = JaxSlamConfig()
    if args.eval and args.boot_sweep:
        result = _boot_sweep(args.eval, args.frames, args.boot_sweep)
        if args.out is not None:
            args.out.write_text(json.dumps(result))
        return
    if args.eval:
        result = _eval(args.eval, args.mode, args.frames)
        result["key_offset"] = args.key_offset
        print(json.dumps({k: v for k, v in result.items() if k != "per_frame"}), flush=True)
        if args.out is not None:
            args.out.write_text(json.dumps(result))
        return
    for kind in ("tum", "euroc"):
        root = getattr(args, kind)
        if root is not None:
            result = _dataset(jcfg, kind, root, args.frames, args.prefix)
            result["key_offset"] = args.key_offset
            if args.out is not None:
                args.out.write_text(json.dumps(result))
            return
    n = args.frames
    if args.kidnap:
        n = max(n, chip_smoke.N_BOOT_FRAMES + 2 * chip_smoke.KIDNAP_STEPS)
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    cam = PinholeCamera.create(fx=520.0, fy=520.0, cx=w / 2 - 0.5, cy=h / 2 - 0.5)
    jcam = JaxCamera.create(520.0, 520.0, w / 2 - 0.5, h / 2 - 0.5)
    room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
    poses = orbit_trajectory(n, radius=2.0, step=0.02, start=-0.35,
                             target=(0.0, 0.0, 2.0))
    t0 = time.perf_counter()
    frames = [room.render(cam, R, t, w, h) for R, t in poses]
    print(f"jax {jax.__version__}; rendered {n} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    if args.slam:
        jcfg = jcfg.replace(pose_graph=jcfg.pose_graph.replace(
            loop_min_gap=chip_smoke.SLAM_LOOP_MIN_GAP))
        seq = chip_smoke.out_and_back(n)
        result = _slam(jcfg, jcam, [frames[i] for i in seq], [poses[i] for i in seq])
        result.update(sequence=seq)
        if args.out is not None:
            args.out.write_text(json.dumps(result))
        return
    if args.bootstrap:
        result = (_kidnap if args.kidnap else _bootstrap)(jcfg, jcam, frames, poses)
        if args.out is not None:
            args.out.write_text(json.dumps(result))
        return
    f0 = extract_features(jnp.asarray(frames[0]), jnp.float32(jcfg.frontend.threshold),
                          jcfg.frontend)
    feats = Features.from_numpy(P.features_numpy(f0))
    xy = feats.xy[feats.valid].numpy().astype(np.float64)
    X = torch.from_numpy(room.raycast(cam, *poses[0], xy).astype(np.float32))
    R0, t0_ = (torch.from_numpy(np.asarray(a, np.float32)) for a in poses[0])
    seed = VOState.seeded(SlamConfig(), feats, X, R0, t0_).to_numpy()
    t0 = time.perf_counter()
    _, ys = track_chunk(jcam, jcfg, P.jax_state(seed), jnp.asarray(np.stack(frames[1:])),
                        jnp.ones(n - 1, bool))
    ys = {k: np.asarray(v) for k, v in ys.items()}
    print(f"tracked {n - 1} frames in {time.perf_counter() - t0:.1f} s (compile included)")

    s = ys["summary"]
    err = np.linalg.norm(np.einsum("nji,nj->ni", ys["R"], -ys["t"])
                         - np.stack([-R.T @ t for R, t in poses[1:]]), axis=1)
    for i in range(n - 1):
        print(i + 1, s[i].tolist(), float(err[i]))
    lost = np.flatnonzero(s[:, 3] < 0.5)
    result = {"frames": n, "max_err": float(err.max()),
              "keyframes": (np.flatnonzero(s[:, 4]) + 1).tolist(),
              "first_lost": int(lost[0] + 1) if len(lost) else None,
              "err": err.tolist(), "summary": s.tolist()}
    print(f"max centre error {result['max_err']}; keyframes at {result['keyframes']}; "
          f"first lost frame {result['first_lost']}")
    if args.out is not None:
        args.out.write_text(json.dumps(result))


def _bootstrap(jcfg, jcam, frames, poses) -> dict:
    """The JAX DeviceVO from frame 0; the result phase 8 is held to."""
    import chip_smoke
    from tinyslam_tpu.models.two_view import TwoViewEstimator
    from tinyslam_tpu.models.vo_device import DeviceVO
    from tinyslam_tpu.utils.evaluation import ate_rmse

    models = []
    estimate = TwoViewEstimator.estimate

    def logged(self, fa, fb, key=None):
        res = estimate(self, fa, fb, key=key)
        models.append((res["model"], int(res["num_inliers"])))
        return res

    TwoViewEstimator.estimate = logged
    vo = DeviceVO(jcfg, jcam, chunk=chip_smoke.CHUNK)
    t0 = time.perf_counter()
    for f in frames:
        vo.process(f)
    vo.flush()
    n = len(frames)
    boot = vo.host_frames - 1
    print(f"DeviceVO from frame 0: {n} frames in {time.perf_counter() - t0:.1f} s "
          f"(compile included); bootstrap at frame {boot}, model {models[-1][0]}, "
          f"{models[-1][1]} inliers, {vo.stats[boot].num_landmarks} landmarks; "
          f"attempts {models}")
    for s in vo.stats:
        print(s.frame, s.tracking, s.is_keyframe, s.num_inliers, s.num_landmarks)
    gt = np.stack([-R.T @ t for R, t in poses])
    first = chip_smoke.BOOT_BUDGET
    ate = ate_rmse(vo.positions[first:], gt[first:])
    lost = [i for i in range(boot, n) if not vo.stats[i].tracking]
    print(f"Sim(3)-aligned ATE over frames {first}-{n - 1}: {ate}; from the "
          f"bootstrap frame: {ate_rmse(vo.positions[boot:], gt[boot:])}; lost after "
          f"the bootstrap: {lost}; keyframes {vo.num_keyframes}")
    return {"frames": n, "bootstrap_frame": boot, "model": models[-1][0],
            "ate": ate, "lost": lost, "num_keyframes": vo.num_keyframes}


def _kidnap(jcfg, jcam, frames, poses) -> dict:
    """Phase 8's forced relocalization at frame 60 and its kidnap sweep on
    the JAX DeviceVO: the result phase 8e's sweep is compared with."""
    import chip_smoke
    from tinyslam_tpu.models.vo_device import DeviceVO

    vo = DeviceVO(jcfg, jcam, chunk=chip_smoke.CHUNK)
    for i in range(chip_smoke.RELOC_FRAME):
        vo.process(frames[i])
    vo.flush()
    vo.force_reloc = True
    for i in range(chip_smoke.RELOC_FRAME, chip_smoke.N_BOOT_FRAMES):
        vo.process(frames[i])
    vo.flush()
    st = vo.stats[chip_smoke.RELOC_FRAME]
    print(f"bootstrap at frame {vo.host_frames - 1}; forced relocalization at frame "
          f"{chip_smoke.RELOC_FRAME}: tracked {st.tracking}, {st.num_inliers} inliers; "
          f"frames 60-100 tracked {sum(s.tracking for s in vo.stats[60:])}/41")
    snap, last = vo.state, chip_smoke.N_BOOT_FRAMES - 1
    sweep = {}
    for jump in range(2, 2 * chip_smoke.KIDNAP_STEPS + 1, 2):
        vo.state = snap
        vo.force_reloc = True
        vo.process(frames[last + jump])
        vo.flush()
        sweep[jump] = (bool(vo.stats[-1].tracking), int(vo.stats[-1].num_inliers))
    print(f"kidnap sweep, orbit steps ahead of frame {last} -> (tracked, inliers): {sweep}")

    # The port from the reference's state: the same frames and draws.
    import torch
    import torch_parity as P
    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.utils.draws import Sampler

    flat = {}
    for f in dataclasses.fields(snap):
        v = getattr(snap, f.name)
        if dataclasses.is_dataclass(v):
            flat.update({f"{f.name}.{g.name}": np.asarray(getattr(v, g.name))
                         for g in dataclasses.fields(v)})
        else:
            flat[f.name] = np.asarray(v)
    lost = vd.VOState.from_numpy(flat, "cpu").replace(
        last_tracking=torch.zeros((), dtype=torch.bool))
    cam = PinholeCamera.create(float(jcam.fx), float(jcam.fy), float(jcam.cx), float(jcam.cy))
    col = {k: i for i, k in enumerate(vd.SUMMARY_FIELDS)}
    port = {}
    for jump in sweep:
        image = torch.from_numpy(frames[last + jump])
        port[jump] = []
        for sampler in (P.JaxSampler(), Sampler(0), Sampler(1), Sampler(2)):
            summary = vd.track_step(cam, SlamConfig(), lost, image, sampler)[1]["summary"]
            port[jump].append((bool(summary[col["tracking"]] > 0),
                               int(summary[col["num_inliers"]])))
    print("the port from the reference's state, (tracked, inliers) with the reference's "
          "draws, then Sampler(0), (1), (2):", port)
    return {"bootstrap_frame": vo.host_frames - 1, "reloc_tracked": bool(st.tracking),
            "sweep": {str(k): v for k, v in sweep.items()},
            "port": {str(k): v for k, v in port.items()}}


def _dataset(jcfg, kind: str, root: str, n: int, prefix: bool) -> dict:
    """The JAX DeviceSlam over the first n frames of a TUM or EuRoC
    sequence, as ``tinyslam_tpu.run`` runs it; the result phase 10 is held
    to.  With ``prefix``, repeated on the prefix before the first reboot
    until a run has none."""
    import jax.numpy as jnp

    import chip_smoke
    from tinyslam_tpu.geometry.camera import PinholeCamera as JaxCamera
    from tinyslam_tpu.models.slam import DeviceSlam
    from tinyslam_tpu.utils.evaluation import ate_rmse
    from tinyslam_tpu_torch.data.euroc import EUROC_CAM0, EurocSequence
    from tinyslam_tpu_torch.data.tum import FR1_INTRINSICS, TumSequence

    if not root:
        from tinyslam_tpu_torch.eval_ate import dataset_sequence

        spec = chip_smoke.TUM_SEQ if kind == "tum" else chip_smoke.EUROC_SEQ
        root, secs = dataset_sequence(spec)
        print(f"{kind}: phase 10's sequence {root} ({secs:.1f} s to render and write)",
              flush=True)
    seq = (TumSequence if kind == "tum" else EurocSequence).open(root)
    cam = JaxCamera.create(**(FR1_INTRINSICS if kind == "tum" else EUROC_CAM0))
    gt = seq.gt_positions() if seq.groundtruth else None
    runs = []
    while True:
        slam = DeviceSlam(jcfg, cam, chunk=16)
        t0 = time.perf_counter()
        frames = 0
        for _, img in seq.frames():
            if frames >= n:
                break
            img = np.asarray(img)
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            slam.process_frame(jnp.asarray(img))
            frames += 1
        slam.finalize()
        vo = slam.vo
        tracked = sum(1 for s in vo.stats if s.tracking)
        ate = None
        if tracked > 5:
            first = next(i for i, s in enumerate(vo.stats) if s.tracking)
            n_eval = min(len(vo.positions), len(gt))
            ate = float(ate_rmse(vo.positions[first:n_eval], gt[first:n_eval]))
        result = {"kind": kind, "frames": frames, "tracked": tracked,
                  "keyframes": vo.num_keyframes, "closures": slam.num_loop_closures,
                  "ate": ate, "reboots": [int(e["frame"]) for e in vo.submap_events],
                  "bootstrap_frame": vo.host_frames - 1 if vo.num_reboots == 0 else None,
                  "lost": [i for i, s in enumerate(vo.stats) if not s.tracking],
                  "landmarks": int(np.sum(np.asarray(vo.map.valid)))}
        runs.append(result)
        print(f"{kind} frames={frames} tracked={tracked} keyframes={vo.num_keyframes} "
              f"loop_closures={slam.num_loop_closures} ATE {ate} reboots at "
              f"{result['reboots']}; lost {result['lost']}; "
              f"{time.perf_counter() - t0:.1f} s (compile included)", flush=True)
        if not (prefix and result["reboots"]):
            break
        n = min(frames - 1, result["reboots"][0])
    result["runs"] = runs[:-1]
    return result


def _eval(name: str, mode: str, n: int) -> dict:
    """tools/eval_ate.py's run_sequence on the port's rendering of its
    sequence ``name`` at ``n`` frames, through the JAX package's loader."""
    import importlib.util
    import os

    import tinyslam_tpu.native as jn
    import torch_parity as P
    from tinyslam_tpu_torch import eval_ate as port

    spec = port.SPECS[name](n)
    root, secs = port.dataset_sequence(spec)
    print(f"{name}: {root} ({f'rendered in {secs:.1f} s' if secs else 'reused'})", flush=True)
    native = ROOT / "build" / "jax_native" / str(os.getpid())
    native.mkdir(parents=True, exist_ok=True)
    jn._SO, jn._lib = P.jax_native_library(native), None
    loader = importlib.util.spec_from_file_location("jax_eval_ate", ROOT / "tools" / "eval_ate.py")
    tool = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(tool)
    # The system the tool builds, kept for its per-frame record.
    import tinyslam_tpu.models as jm

    made, real = [], {k: getattr(jm, k) for k in ("DeviceSlam", "DeviceVO")}
    for k, cls in real.items():
        setattr(jm, k, lambda *a, _cls=cls, **kw: made.append(_cls(*a, **kw)) or made[-1])
    try:
        t0 = time.perf_counter()
        result = tool.run_sequence(port.SEQUENCES[name], spec["kind"], root, mode, "device")
    finally:
        for k, cls in real.items():
            setattr(jm, k, cls)
    print(f"{name} {mode}: {time.perf_counter() - t0:.1f} s (compile included)", flush=True)
    system = made[-1]
    vo = system.vo if mode == "slam" else system
    result["per_frame"] = {
        "summary": [[int(s.tracking), int(s.is_keyframe), s.num_features, s.num_matches,
                     s.num_inliers, s.num_landmarks] for s in vo.stats],
        "centres": np.asarray(system.raw_positions if mode == "slam" else vo.positions,
                              np.float64).tolist(),
        "reboots": [int(e["frame"]) for e in vo.submap_events]}
    if mode == "slam":
        result["per_frame"].update(
            loop_log=system.loop_log,
            kf_frame_of={str(k): int(f) for k, f in system.kf_frame_of.items()})
    return result


def _boot_sweep(name: str, n: int, offsets: int) -> dict:
    """The first two-view bootstrap attempt on sequence ``name`` (the host
    tracker's, frame 3 against frame 0): the JAX ``TwoViewEstimator`` and
    the port's on the CPU, each on the features its own ``VisualOdometry``
    extracted, under the reference's draws at key offsets 0..offsets-1.
    Per offset: each one's inliers, median parallax, whether the attempt
    passes the bootstrap's gates, and the angle of its translation to the
    ground truth's."""
    import jax

    import torch_parity as P
    from tinyslam_tpu.config import SlamConfig as JaxSlamConfig
    from tinyslam_tpu.geometry.camera import PinholeCamera as JaxCamera
    from tinyslam_tpu.models.vo import VisualOdometry as JaxVO
    from tinyslam_tpu_torch import SlamConfig, eval_ate as port
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models.vo import VisualOdometry

    spec = port.SPECS[name](n)
    root, _ = port.dataset_sequence(spec)
    seq = (port.TumSequence if spec["kind"] == "tum" else port.EurocSequence).open(root)
    intr = port.FR1_INTRINSICS if spec["kind"] == "tum" else port.EUROC_CAM0
    cfg, jcfg = SlamConfig(), JaxSlamConfig()
    pairs = {}
    jvo = JaxVO(jcfg, JaxCamera.create(**intr))
    jest = jvo.two_view.estimate
    jvo.two_view.estimate = lambda fa, fb, key=None: (
        pairs.setdefault("jax", (fa, fb)), jest(fa, fb, key))[1]
    tvo = VisualOdometry(cfg, PinholeCamera.create(**intr), device="cpu",
                         sampler=P.JaxSampler())
    test = tvo.two_view.estimate
    tvo.two_view.estimate = lambda fa, fb, sampler, seed=0: (
        pairs.setdefault("port", (fa, fb, seed)), test(fa, fb, sampler, seed=seed))[1]
    for _, image in seq.frames():
        if len(pairs) == 2:
            break
        jvo.process(image)
        tvo.process(image)
    frame = pairs["port"][2]
    (_, Ra, ta), (_, Rb, tb) = seq.groundtruth[0], seq.groundtruth[frame]
    R_gt = Rb @ Ra.T
    t_gt = tb - R_gt @ ta
    t_gt /= np.linalg.norm(t_gt)

    def gates(res) -> dict:
        g = {k: np.asarray(v, np.float64) for k, v in res.items() if k != "model"}
        mv, inl, X = g["match_valid"] > 0.5, g["inliers"] > 0.5, g["points"]
        good = inl & mv & np.isfinite(X).all(-1) & (X[:, 2] > 0.1) & (X[:, 2] < 1e4)
        C1 = -g["R"].T @ g["t"]
        Xg = X[good]
        r1 = Xg - C1
        cosp = np.sum(Xg * r1, -1) / np.maximum(
            np.linalg.norm(Xg, axis=-1) * np.linalg.norm(r1, axis=-1), 1e-12)
        par = float(np.degrees(np.arccos(np.clip(np.median(cosp), -1, 1)))) if len(Xg) else None
        t = g["t"] / np.linalg.norm(g["t"])
        return {"matches": int(mv.sum()), "inliers": int(g["num_inliers"]),
                "parallax_deg": par,
                "passes": bool(mv.sum() >= 50 and g["num_inliers"] >= 60 and good.sum() >= 50
                               and par is not None and par >= cfg.vo.min_parallax_deg),
                "t_to_gt_deg": float(np.degrees(np.arccos(np.clip(t @ t_gt, -1, 1))))}

    rows = []
    for k in range(offsets):
        rows.append({"key_offset": k,
                     "jax": gates(jest(*pairs["jax"], key=jax.random.PRNGKey(frame + 1000 * k))),
                     "port": gates(test(*pairs["port"][:2], P.JaxSampler(k), seed=frame))})
        print(json.dumps(rows[-1]), flush=True)
    same = sum(r["jax"]["passes"] == r["port"]["passes"] for r in rows)
    result = {"sequence": port.SEQUENCES[name], "frame": frame, "offsets": offsets,
              "passes": [sum(r[s]["passes"] for r in rows) for s in ("jax", "port")],
              "same_decision": same, "rows": rows}
    print(f"{name}: the bootstrap attempt at frame {frame} passes under {result['passes'][0]} "
          f"(JAX) and {result['passes'][1]} (port) of {offsets} key offsets; the same decision "
          f"at {same}", flush=True)
    return result


def _slam(jcfg, jcam, frames, poses) -> dict:
    """The JAX DeviceSlam from frame 0; the result phase 9 is held to."""
    import chip_smoke
    from tinyslam_tpu.models.slam import DeviceSlam
    from tinyslam_tpu.utils.evaluation import ate_rmse

    slam = DeviceSlam(jcfg, jcam, chunk=chip_smoke.CHUNK)
    t0 = time.perf_counter()
    for f in frames:
        slam.process_frame(f)
    slam.finalize()
    n = len(frames)
    boot = slam.vo.host_frames - 1
    gt = np.stack([-R.T @ t for R, t in poses])
    ate = ate_rmse(slam.positions[boot:], gt[boot:])
    raw = ate_rmse(slam.raw_positions[boot:], gt[boot:])
    lost = [i for i in range(boot, n) if not slam.vo.stats[i].tracking]
    log = [{k: (float(v) if isinstance(v, (float, np.floating)) else v) for k, v in r.items()}
           for r in slam.loop_log]
    print(f"DeviceSlam from frame 0: {n} frames in {time.perf_counter() - t0:.1f} s "
          f"(compile included); bootstrap at frame {boot}; {len(slam.kf_R)} keyframes at "
          f"frames {sorted(slam.kf_frame_of.values())}; lost after the bootstrap: {lost}")
    for r in log:
        print("loop candidate", r)
    print("edges", [(i, j, round(s, 4), w) for i, j, _, _, s, w in slam.edges])
    print(f"accepted closures {slam.num_loop_closures}; Sim(3)-aligned ATE from the "
          f"bootstrap frame: corrected {ate}, raw {raw}; timings {slam.timings}")
    return {"frames": n, "bootstrap_frame": boot, "closures": slam.num_loop_closures,
            "ate": ate, "raw_ate": raw, "lost": lost, "num_keyframes": len(slam.kf_R),
            "kf_frame_of": {str(k): v for k, v in slam.kf_frame_of.items()},
            "loop_log": log,
            "edges": [(i, j, float(s), float(w)) for i, j, _, _, s, w in slam.edges]}


if __name__ == "__main__":
    main()
