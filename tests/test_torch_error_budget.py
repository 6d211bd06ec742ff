"""The port's error budget (``tinyslam_tpu_torch/error_budget.py``) against
the JAX package's (``tools/error_budget.py``), on the CPU.

- ``_windowed_scale`` and ``_dist_travelled`` equal the JAX tool's on
  seeded trajectories, a window whose ground truth stands still (skipped
  by the ``ptp`` check) included.
- ``budget_for_sequence`` on the 160x120 out-and-back TUM sequence of
  ``tests/test_torch_eval.py`` (``torch_config(keyframes=True)`` with
  ``loop_min_gap`` 3, the JAX draws replayed by ``JaxSampler``) against
  the JAX tool's on the same files: the same keys; tracked frames, frames,
  reboots, drift segments, the first tracked frame, the loop candidates
  and their (kf, old, accepted), tp/fp/fn/tn, closures and keyframes equal;
  ATEs within 1e-3 m and scales within 1e-3 relative (the tolerances of
  ``tests/test_torch_eval.py``).
- ``main`` writes the reports with the JAX tool's keys, the card's
  ``nvidia-smi`` line and the seed; ``--device cuda`` without a card raises.
- ``JaxSampler(key_offset=k)`` draws what the JAX package draws under
  ``tools/jax_reference_orbit.py --key-offset k``'s ``PRNGKey`` stand-in.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_parity as P
from tinyslam_tpu_torch import error_budget

REPO = Path(__file__).resolve().parents[1]
LOOP_MIN_GAP = 3
N_OUT = 22          # orbit frames 0-21, then 20-0
ATE_M = 1e-3
SCALE_REL = 1e-3


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_error_budget",
                                                  REPO / "tools" / "error_budget.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trajectories(seed: int, n: int, still: tuple[int, int] | None):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0.0, 0.05, (n, 3)), axis=0)
    if still is not None:
        gt[still[0]:still[1]] = gt[still[0]]
    est = 0.7 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(0.0, 0.01, (n, 3))
    return est, gt


@pytest.mark.parametrize("seed,n,win,still", [(1, 100, 30, None), (2, 61, 30, None),
                                               (3, 120, 30, (20, 70)), (4, 40, 8, (0, 12)),
                                               (5, 30, 30, None)])
def test_windowed_scale_and_distance_equal_jax_tool(seed, n, win, still):
    tool = _jax_tool()
    est, gt = _trajectories(seed, n, still)
    got, want = error_budget._windowed_scale(est, gt, win), tool._windowed_scale(est, gt, win)
    assert got == want
    if still is not None:       # the ptp check skipped a window
        assert len(want) < len(range(0, n - win, max(win // 2, 1)))
    assert error_budget._dist_travelled(gt) == tool._dist_travelled(gt)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    return P.out_and_back_tum(tmp_path_factory.mktemp("budget") / "fr1_desk_like", N_OUT)


@pytest.fixture(scope="module")
def budgets(sequence, tmp_path_factory):
    """(the JAX tool's report, the port's report) on the small sequence."""
    with pytest.MonkeyPatch.context() as mp:
        P.small_tools(mp, tmp_path_factory.mktemp("native"), LOOP_MIN_GAP, error_budget)
        want = _jax_tool().budget_for_sequence("fr1_desk_like", "tum", sequence)
        got = error_budget.budget_for_sequence("fr1_desk_like", "tum", sequence,
                                               device="cpu", sampler=P.JaxSampler())
    return json.loads(json.dumps(want, default=str)), json.loads(json.dumps(got, default=str))


def _keys(report: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) else None for k, v in report.items()}


VO_EQUAL = ("tracked", "frames", "reboots", "drift_segment")
VO_ATE = ("ate_sim3_m", "ate_se3_m")
GATES_EQUAL = ("candidates", "tp", "fp", "fn", "tn", "precision", "recall")
SLAM_EQUAL = ("loop_closures", "keyframes", "reboots")
SLAM_ATE = ("ate_sim3_m", "ate_se3_m", "ate_raw_sim3_m")


@pytest.mark.parametrize("stage", ["vo_ba_on", "vo_ba_off", "bootstrap", "loop_gates", "slam"])
def test_budget_for_sequence_matches_jax_tool(stage, budgets):
    want, got = budgets
    assert _keys(got) == _keys(want)
    w, g = want[stage], got[stage]
    if stage.startswith("vo_"):
        assert [g[k] for k in VO_EQUAL] == [w[k] for k in VO_EQUAL]
        assert g["tracked"] >= N_OUT
        for k in VO_ATE:
            assert g[k] == pytest.approx(w[k], abs=ATE_M), k
        assert g["dist_travelled_m"] == pytest.approx(w["dist_travelled_m"], abs=0.01)
        assert [x["frame"] for x in g["windowed_scale"]] == \
            [x["frame"] for x in w["windowed_scale"]]
        for a, b in zip(g["windowed_scale"], w["windowed_scale"]):
            assert a["scale"] == pytest.approx(b["scale"], rel=SCALE_REL)
            assert a["rmse"] == pytest.approx(b["rmse"], abs=ATE_M)
        assert g["scale_drift_logspread"] == pytest.approx(w["scale_drift_logspread"],
                                                           abs=2 * SCALE_REL)
    elif stage == "bootstrap":
        assert g["first_tracked_frame"] == w["first_tracked_frame"]
        assert g["window_scale_vs_run"] == pytest.approx(w["window_scale_vs_run"],
                                                         rel=SCALE_REL)
        assert g["window_rmse_m"] == pytest.approx(w["window_rmse_m"], abs=ATE_M)
    elif stage == "loop_gates":
        assert [g[k] for k in GATES_EQUAL] == [w[k] for k in GATES_EQUAL]
        assert g["candidates"] >= 1 and g["tp"] >= 1
        assert [(r["kf"], r["old"], r["accepted"]) for r in g["log"]] == \
            [(r["kf"], r["old"], r["accepted"]) for r in w["log"]]
        assert g["accepted_scales"] == pytest.approx(w["accepted_scales"], rel=SCALE_REL)
    else:
        assert [g[k] for k in SLAM_EQUAL] == [w[k] for k in SLAM_EQUAL]
        assert g["loop_closures"] >= 1
        for k in SLAM_ATE:
            assert g[k] == pytest.approx(w[k], abs=ATE_M), k


def test_main_writes_the_jax_tools_keys(sequence, budgets, monkeypatch, tmp_path, capsys):
    """``--keep`` with the sequence already there: nothing is rendered."""
    P.small_tools(monkeypatch, tmp_path, LOOP_MIN_GAP, error_budget)
    keep = tmp_path / "keep"
    keep.mkdir()
    (keep / "fr1_desk_like").symlink_to(sequence)
    out = tmp_path / "ERRBUDGET.json"
    assert error_budget.main(["--device", "cpu", "--keep", str(keep), "--seq", "fr1",
                              "--out", str(out), "--seed", "2"]) == 0
    art = json.loads(out.read_text())
    assert set(art) == {"reports", "nvidia_smi", "seed"}
    assert art["seed"] == 2 and art["nvidia_smi"] is None
    (rep,) = art["reports"]
    assert _keys(rep) == _keys(budgets[0]) and rep["sequence"] == "fr1_desk_like"
    assert set(rep["loop_gates"]["log"][0]) == set(budgets[0]["loop_gates"]["log"][0])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-2]) == json.loads(error_budget.summary_line(rep))


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        error_budget.main(["--seq", "fr1", "--out", str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        error_budget.budget_for_sequence("fr1_desk_like", "tum", tmp_path, device="cuda")
    assert not (tmp_path / "x.json").exists()


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("key", [("two_view", 7, "E"), ("two_view", 7, "H"), ("reloc", 12),
                                 ("host_reloc", 5), ("loop", 9 * 131 + 2)])
def test_jax_sampler_key_offset(offset, key, monkeypatch):
    """The JAX package's own derivations under the reference tool's
    ``PRNGKey`` stand-in, against ``JaxSampler(key_offset)``."""
    import jax

    def package_key(kind, n):
        r = jax.random
        if kind == "two_view":
            return r.split(r.PRNGKey(n))[0 if key[2] == "E" else 1]
        return {"reloc": lambda: r.fold_in(r.PRNGKey(17), n),
                "host_reloc": lambda: r.PRNGKey(n),
                "loop": lambda: r.fold_in(r.PRNGKey(23), n)}[kind]()

    with monkeypatch.context() as mp:
        real = jax.random.PRNGKey
        mp.setattr(jax.random, "PRNGKey",
                   lambda n, *a, **kw: real(n + 1000 * offset, *a, **kw))
        want = np.array(jax.random.uniform(package_key(key[0], key[1]), (64,)))
    got = P.JaxSampler(key_offset=offset).uniform((64,), "cpu", key=key).numpy()
    np.testing.assert_array_equal(got, want)
    if offset:
        assert not np.array_equal(got, P.JaxSampler().uniform((64,), "cpu", key=key).numpy())
