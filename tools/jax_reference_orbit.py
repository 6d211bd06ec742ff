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

    python tools/jax_reference_orbit.py --frames 189 [--out ref.json]
    python tools/jax_reference_orbit.py --bootstrap --frames 101
    python tools/jax_reference_orbit.py --slam --frames 101

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
    ap.add_argument("--frames", type=int, default=189)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--bootstrap", action="store_true",
                    help="run DeviceVO from frame 0 instead of a seeded map")
    ap.add_argument("--slam", action="store_true",
                    help="run DeviceSlam from frame 0 over the out-and-back")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

    import jax

    jax.config.update("jax_platforms", "cpu")
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

    n = args.frames
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

    jcfg = JaxSlamConfig()
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
        result = _bootstrap(jcfg, jcam, frames, poses)
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
