"""The port runs without JAX: in a fresh interpreter where ``import jax``
fails, every module of tinyslam_tpu_torch imports (``eval_ate`` among
them), ``DeviceVO`` and ``DeviceSlam`` bootstrap from frame 0 of a
rendered 160x120 orbit and track it on the CPU, a checkpoint of the
tracker restores into a fresh one without Orbax, and the command line
runs 6 synthetic frames there and a TUM sequence written by the port's
writer, read through the native loader it builds, and
``entry(device="cpu")``'s tracked step runs, launching no CUDA kernel."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None           # any import of jax now raises ImportError
sys.modules["flax"] = None
sys.modules["orbax"] = None
import numpy as np, torch
torch.set_num_threads(2)
import tinyslam_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(tinyslam_tpu_torch.__path__, "tinyslam_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from tinyslam_tpu_torch.config import FrontendConfig, SlamConfig, VOConfig
from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models.vo_device import DeviceVO
from tinyslam_tpu_torch.ops import fast_cuda, match_cuda
cam = PinholeCamera.create(130.0, 130.0, 79.5, 59.5)
room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
poses = orbit_trajectory(10, radius=2.0, step=0.02, start=-0.35, target=(0.0, 0.0, 2.0))
frames = [room.render(cam, R, t, 160, 120) for R, t in poses]
cfg = SlamConfig(frontend=FrontendConfig(height=120, width=160, num_levels=2,
                                         features_per_level=128),
                 vo=VOConfig(max_map_points=512))
vo = DeviceVO(cfg, cam, chunk=4, device="cpu")
stats = vo.run(frames)
import tempfile
from pathlib import Path
from tinyslam_tpu_torch.utils.checkpoint import restore_device_vo, save_device_vo
ck = Path(tempfile.mkdtemp()) / "ck"
save_device_vo(vo, ck)
back = DeviceVO(cfg, cam, chunk=4, device="cpu")
restore_device_vo(back, ck)
ckpt = bool(np.array_equal(back.positions, vo.positions) and back.initialized)
from tinyslam_tpu_torch.models.slam import DeviceSlam
slam = DeviceSlam(cfg, cam, chunk=4, device="cpu")
slam.run(frames)
import contextlib, io
from tinyslam_tpu_torch import run
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = run.main(["--device", "cpu", "--frames", "6"])
import tempfile
from pathlib import Path
from tinyslam_tpu_torch import native
from tinyslam_tpu_torch.data.synthetic import apply_photometrics, write_tum_sequence
lib = native.build()
tmp = Path(tempfile.mkdtemp())
rng = np.random.default_rng(8)
write_tum_sequence(tmp / "seq", [apply_photometrics(f, rng) for f in frames], poses)
(tmp / "cfg.json").write_text(cfg.to_json())
tum_out = io.StringIO()
with contextlib.redirect_stdout(tum_out):
    tum_rc = run.main(["--dataset", "tum", "--root", str(tmp / "seq"), "--config",
                       str(tmp / "cfg.json"), "--fx", "130", "--fy", "130", "--cx", "79.5",
                       "--cy", "59.5", "--chunk", "4", "--device", "cpu"])
from tinyslam_tpu_torch.entry import entry
fn, args = entry(device="cpu")
_, entry_ys = fn(*args)
print(json.dumps({"entry": entry_ys["summary"].tolist(), "ckpt": ckpt,
                  "eval_ate": "tinyslam_tpu_torch.eval_ate" in mods, "tum": [tum_rc, tum_out.getvalue().splitlines()[0], str(lib.parent)],"modules": len(mods), "count": stats[0].num_features,
                  "slam": [slam.vo.initialized, len(slam.kf_R), slam.vo.num_keyframes,
                           len(slam.positions)],
                  "cli": [rc, out.getvalue().splitlines()[0]],
                  "tracking": stats[-1].tracking, "initialized": vo.initialized,
                  "jax_loaded": any(k.split(".")[0] in ("jax", "jaxlib", "orbax")
                                    and v is not None
                                    for k, v in sys.modules.items()),
                  "launches": [fast_cuda.LAUNCHES, match_cuda.LAUNCHES]}))
"""


@pytest.fixture(scope="module")
def result():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_and_tracks_without_jax(result):
    assert result["modules"] >= 43
    assert result["eval_ate"]       # imported with jax, flax and orbax unimportable
    assert not result["jax_loaded"]
    assert result["count"] > 100
    assert result["initialized"]
    assert result["tracking"]
    assert result["ckpt"]
    initialized, n_kf, vo_kf, n_pos = result["slam"]
    assert initialized and n_kf == vo_kf >= 2 and n_pos == 10
    rc, line = result["cli"]
    assert rc == 0 and line.startswith("frames=6 ") and "loop_closures=" in line
    rc, line, lib_dir = result["tum"]
    assert rc == 0 and line.startswith("frames=10 ") and "loop_closures=" in line
    assert Path(lib_dir) == REPO / "build" / "tinyslam_tpu_torch"
    # entry()'s tracked step: 256 seeded landmarks, nothing matched.
    assert result["entry"][5] == 256 and result["entry"][1] == 0 and result["entry"][0] > 1000


def test_cpu_tensors_launch_no_kernel(result):
    assert result["launches"] == [0, 0]


def test_no_jax_import_in_the_port():
    """No module of the port, nor chip_smoke.py, imports jax, flax, orbax
    or the JAX package."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|orbax|tinyslam_tpu)\b(?!_torch)", re.M)
    files = sorted((REPO / "tinyslam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 15
    for f in files:
        assert not pattern.search(f.read_text()), f
