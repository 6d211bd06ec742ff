"""The port's command line on the CPU: ``--dataset synthetic`` exits 0
with a summary line in both modes and with both trackers (``--mode slam``
over the chunked tracker, ``--mode vo`` with the host one); ``--dataset
tum`` and ``euroc`` run a sequence written by the port's writers, through
the native loader, and hand the tracker the frames the JAX package's
loader yields."""

from __future__ import annotations

import re

import numpy as np
import pytest

from tests import torch_parity as P  # noqa: F401  (sets the torch thread count)
from tinyslam_tpu_torch import run

_SUMMARY = re.compile(r"^frames=(\d+) tracked=(\d+) keyframes=(\d+) landmarks=(\d+) "
                      r"fps=([\d.]+)(?: loop_closures=(\d+))?$", re.M)


@pytest.mark.parametrize("mode,tracker", [("slam", "device"), ("vo", "host")])
def test_cli_runs_synthetic(mode, tracker, capsys, tmp_path):
    out = tmp_path / "traj.txt"
    assert run.main(["--device", "cpu", "--dataset", "synthetic", "--frames", "12",
                     "--mode", mode, "--tracker", tracker, "--chunk", "4",
                     "--output", str(out), "--metrics", str(tmp_path / "m.json")]) == 0
    text = capsys.readouterr().out
    m = _SUMMARY.search(text)
    assert m, text
    frames, tracked, keyframes, landmarks = (int(g) for g in m.groups()[:4])
    assert frames == 12 and 0 < tracked <= 12 and keyframes >= 2 and landmarks > 0
    assert (m.group(6) is not None) == (mode == "slam")
    assert "ATE RMSE (Sim3)" in text
    assert len(out.read_text().splitlines()) == 12


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's loaders read through a private build of its own
    native sources."""
    import tinyslam_tpu.native as jn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_SO", P.jax_native_library(tmp_path_factory.mktemp("jax_native")))
        mp.setattr(jn, "_lib", None)
        yield


@pytest.mark.parametrize("dataset", ["tum", "euroc"])
def test_cli_runs_dataset(dataset, capsys, tmp_path, monkeypatch, jax_native):
    """12 frames of the 160x120 synthetic sequence with real-camera
    photometrics (RGB for TUM, gray for EuRoC) under the small config."""
    from tinyslam_tpu.data.euroc import EurocSequence
    from tinyslam_tpu.data.tum import TumSequence
    from tinyslam_tpu_torch.data.synthetic import (apply_photometrics, vo_sequence,
                                                   write_euroc_sequence, write_tum_sequence)
    from tinyslam_tpu_torch.models import DeviceSlam

    cam, frames, poses, _ = vo_sequence(np.random.default_rng(7), num_frames=12,
                                        width=P.WIDTH, height=P.HEIGHT)
    rng = np.random.default_rng(8)
    frames = [apply_photometrics(f, rng, exposure=1.0 + 0.01 * i) for i, f in enumerate(frames)]
    root = tmp_path / dataset
    if dataset == "tum":
        write_tum_sequence(root, [np.stack([f, f, f], -1) for f in frames], poses)
        want = [f for _, f in TumSequence.open(root).frames()]
    else:
        write_euroc_sequence(root, frames, poses)
        want = [f for _, f in EurocSequence.open(root).frames()]
    (tmp_path / "cfg.json").write_text(P.torch_config(keyframes=True).to_json())
    fed = []
    real = DeviceSlam.process_frame
    monkeypatch.setattr(DeviceSlam, "process_frame",
                        lambda self, img: (fed.append(img), real(self, img))[1])
    out = tmp_path / "traj.txt"
    intrinsics = [f"--{k}={getattr(cam, k)}" for k in ("fx", "fy", "cx", "cy")]
    assert run.main(["--device", "cpu", "--dataset", dataset, "--root", str(root),
                     "--config", str(tmp_path / "cfg.json"), "--chunk", "4", *intrinsics,
                     "--output", str(out), "--metrics", str(tmp_path / "m.json")]) == 0
    text = capsys.readouterr().out
    m = _SUMMARY.search(text)
    assert m, text
    frames_n, tracked, keyframes, landmarks = (int(g) for g in m.groups()[:4])
    assert frames_n == 12 and 5 < tracked <= 12 and keyframes >= 2 and landmarks > 0
    assert m.group(6) is not None
    assert "ATE RMSE (Sim3)" in text
    assert len(out.read_text().splitlines()) == 12
    assert len(fed) == len(want) == 12
    for got, w in zip(fed, want):
        assert got.dtype == np.float32 and got.shape == w.shape
        np.testing.assert_array_equal(got, w.astype(np.float32) / 255.0)
