"""The port's accuracy evaluation (``tinyslam_tpu_torch/eval_ate.py``,
``utils/evaluation.py:rpe``) against the JAX package's
(``tools/eval_ate.py``, ``tinyslam_tpu/utils/evaluation.py``), on the CPU.

- ``rpe`` equals the JAX ``rpe`` bit for bit on seeded pose lists.
- The three builders, cut to 3 frames and texture resolution 16, write
  files byte-identical to the JAX tool's builders.
- ``run_sequence`` on one small TUM sequence written by the port (the
  160x120 orbit out and back, ``torch_config(keyframes=True)`` with
  ``loop_min_gap`` 3, the JAX draws replayed by ``JaxSampler``) against the
  JAX tool's ``run_sequence`` on the same files, ``slam``/``device`` and
  ``vo``/``host``: frames, tracked frames, keyframes, closures and reboots
  equal; ATE (Sim(3), SE(3), raw) and RPE (translation) within 1e-3 m and
  RPE (rotation) within 0.05 degrees (``test_torch_slam_device.py``'s ATE
  tolerance; its centres agree within 2e-3 m).
- ``main`` writes an artifact with the JAX tool's keys; ``--device cuda``
  without a card raises.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_parity as P
from tinyslam_tpu.utils import evaluation as jev
from tinyslam_tpu_torch import eval_ate
from tinyslam_tpu_torch.utils import evaluation as tev

REPO = Path(__file__).resolve().parents[1]
LOOP_MIN_GAP = 3
# The small sequence: orbit frames 0-21, then 20-0.
N_OUT = 22


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_eval_ate", REPO / "tools" / "eval_ate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _poses(rng, n):
    from tinyslam_tpu_torch.geometry.se3 import so3_exp

    return [(so3_exp(torch.from_numpy(rng.normal(0.0, 0.4, 3))).numpy(), rng.normal(0.0, 1.0, 3))
            for _ in range(n)]


@pytest.mark.parametrize("delta,n", [(1, 30), (3, 30), (3, 3)])
def test_rpe_equals_jax(delta, n):
    rng = np.random.default_rng(11 + delta + n)
    est, gt = _poses(rng, n), _poses(rng, n + 2)
    got, want = tev.rpe(est, gt, delta), jev.rpe(est, gt, delta)
    if n <= delta:          # no pair: both are the mean of nothing
        assert np.isnan(got).all() and np.isnan(want).all()
    else:
        assert got == want


@pytest.mark.parametrize("name", ["fr1_desk_like", "fr1_loop_like", "mh01_like"])
def test_builders_equal_jax_tool(name, tmp_path, monkeypatch):
    """3 frames, texture resolution 16 (the JAX builder's room through a
    patched ``TexturedRoom``), two render workers."""
    from tinyslam_tpu.data import synthetic as jsyn

    real = jsyn.TexturedRoom
    monkeypatch.setattr(jsyn, "TexturedRoom", lambda rng, **kw: real(rng, **dict(kw, tex_res=16)))
    getattr(_jax_tool(), f"build_{name}")(tmp_path / "jax", 3)
    getattr(eval_ate, f"build_{name}")(tmp_path / "port", 3, workers=2, tex_res=16)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) >= 4
    assert sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                  if p.is_file()) == files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_fr1_loop_returns_to_its_start():
    """The loop's step scales with its length: at any length the walk
    turns ~378 degrees and ends within a metre of its start."""
    for n in (60, 300):
        _, _, _, poses, _ = eval_ate._scene(eval_ate.fr1_loop_spec(n, tex_res=16))
        C = np.stack([-R.T @ t for R, t in poses])
        assert len(poses) == n and np.linalg.norm(C[-1] - C[0]) < 1.0


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """The 160x120 orbit out and back with real-camera photometrics,
    written in the TUM layout by the port's writer."""
    return P.out_and_back_tum(tmp_path_factory.mktemp("eval") / "fr1_desk_like", N_OUT)


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Both tools on the small set-up: ``SlamConfig`` and ``FR1_INTRINSICS``
    replaced in their namespaces; the JAX loader through a private build
    of its native sources."""
    P.small_tools(monkeypatch, tmp_path, LOOP_MIN_GAP, eval_ate)


EQUAL = ("frames", "tracked", "keyframes", "loop_closures", "reboots", "host_frames")
CLOSE = {"ate_rmse_m": 1e-3, "ate_se3_m": 1e-3, "ate_raw_m": 1e-3, "rpe_trans_m": 1e-3,
         "rpe_rot_deg": 0.05}


@pytest.mark.parametrize("mode,tracker", [("slam", "device"), ("vo", "host")])
def test_run_sequence_matches_jax_tool(mode, tracker, sequence, small):
    want = _jax_tool().run_sequence("fr1_desk_like", "tum", sequence, mode, tracker)
    got = eval_ate.run_sequence("fr1_desk_like", "tum", sequence, mode, tracker,
                                device="cpu", sampler=P.JaxSampler())
    assert set(got) == set(want)
    assert got["backend"] == "cpu" == want["backend"]
    assert got["frames"] == 2 * N_OUT - 1 and got["tracked"] >= N_OUT
    assert [got[k] for k in EQUAL] == [want[k] for k in EQUAL]
    if mode == "slam":
        assert got["loop_closures"] >= 1 and got["ate_raw_m"] != got["ate_rmse_m"]
        assert [(r["kf"], r["old"], r["accepted"]) for r in got["loop_log_tail"]] == \
            [(r["kf"], r["old"], r["accepted"]) for r in want["loop_log_tail"]]
    for k, tol in CLOSE.items():
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert got[k] == pytest.approx(want[k], abs=tol), k
    assert np.isfinite([got[k] for k in ("fps", "steady_fps", "data_fps")]).all()


def test_main_writes_the_jax_tools_keys(sequence, small, tmp_path, capsys):
    """``--keep`` with the sequence already there: nothing is rendered."""
    keep = tmp_path / "keep"
    keep.mkdir()
    (keep / "fr1_desk_like").symlink_to(sequence)
    out = tmp_path / "EVAL.json"
    assert eval_ate.main(["--device", "cpu", "--keep", str(keep), "--only", "fr1", "--out",
                          str(out), "--mode", "vo", "--frames", "12", "--seed", "1"]) == 0
    art = json.loads(out.read_text())
    assert {"target_ate_m", "note", "results"} <= set(art) and art["seed"] == 1
    assert art["nvidia_smi"] is None
    (res,) = art["results"]
    assert set(res) == {
        "sequence", "mode", "tracker", "frames", "tracked", "reboots", "host_frames",
        "keyframes", "loop_closures", "ate_rmse_m", "ate_se3_m", "ate_raw_m", "rpe_trans_m",
        "rpe_rot_deg", "fps", "steady_fps", "warmup_s", "data_fps", "backend",
        "stage_budget_s", "loop_log_tail"}
    assert res["sequence"] == "fr1_desk_like" and res["mode"] == "vo"
    assert res["frames"] == 2 * N_OUT - 1 and res["backend"] == "cpu"
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == res


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_ate.main(["--only", "fr1", "--out", str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_ate.run_sequence("fr1_desk_like", "tum", tmp_path, "slam", "device",
                              device="cuda")
    assert not (tmp_path / "x.json").exists()
