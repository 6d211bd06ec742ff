"""The port's command line on the CPU: ``--dataset synthetic`` exits 0
with a summary line in both modes and with both trackers (``--mode slam``
over the chunked tracker, ``--mode vo`` with the host one); the dataset
loaders that need the native frame loader raise."""

from __future__ import annotations

import re

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


@pytest.mark.parametrize("dataset", ["tum", "euroc"])
def test_cli_dataset_loaders_raise(dataset):
    with pytest.raises(NotImplementedError, match="native frame loader"):
        run.main(["--device", "cpu", "--dataset", dataset, "--root", "nowhere"])
