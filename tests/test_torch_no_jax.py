"""The port runs without JAX: in a fresh interpreter where ``import jax``
fails, every module of tinyslam_tpu_torch imports, a 160x120 frame is
rendered and tracked on the CPU, and no CUDA kernel is launched."""

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
import numpy as np, torch
torch.set_num_threads(2)
import tinyslam_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(tinyslam_tpu_torch.__path__, "tinyslam_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from tinyslam_tpu_torch.config import FrontendConfig, SlamConfig, VOConfig, slice_config
from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory
from tinyslam_tpu_torch.frontend.orb import extract_features
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models.vo_device import VOState, track_step
from tinyslam_tpu_torch.ops import fast_cuda, match_cuda
cam = PinholeCamera.create(130.0, 130.0, 79.5, 59.5)
room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
poses = orbit_trajectory(2, radius=2.0, step=0.02, start=-0.35, target=(0.0, 0.0, 2.0))
frames = [torch.from_numpy(room.render(cam, R, t, 160, 120)) for R, t in poses]
cfg = slice_config(SlamConfig(
    frontend=FrontendConfig(height=120, width=160, num_levels=2, features_per_level=128),
    vo=VOConfig(max_map_points=512)))
feats = extract_features(frames[0], 0.06, cfg.frontend)
xy = feats.xy[feats.valid].numpy().astype(np.float64)
X = torch.from_numpy(room.raycast(cam, *poses[0], xy).astype(np.float32))
state = VOState.seeded(cfg, feats, X, *(torch.from_numpy(a) for a in poses[0]))
state, ys = track_step(cam, cfg, state, frames[1])
print(json.dumps({"modules": len(mods), "count": int(feats.count),
                  "tracking": bool(state.last_tracking),
                  "jax_loaded": any(k.split(".")[0] in ("jax", "jaxlib") and v is not None
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
    assert result["modules"] >= 15
    assert not result["jax_loaded"]
    assert result["count"] > 100
    assert result["tracking"]


def test_cpu_tensors_launch_no_kernel(result):
    assert result["launches"] == [0, 0]


def test_no_jax_import_in_the_port():
    """No module of the port, nor chip_smoke.py, imports jax or flax."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|tinyslam_tpu)\b(?!_torch)", re.M)
    files = sorted((REPO / "tinyslam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 15
    for f in files:
        assert not pattern.search(f.read_text()), f
