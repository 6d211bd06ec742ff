"""The port's entry points (``tinyslam_tpu_torch/entry.py``)
against the JAX package's ``__graft_entry__.py``: ``entry()`` builds the
same inputs from the same numpy draws and its tracked step gives the JAX
step's summary (matches, inliers, flags and landmarks equal, features
within 1%, the threshold within 1e-6); ``dryrun_multichip`` runs every
stage over 2 and 4 gloo ranks on the CPU and prints the JAX line's fields.
Both default to the card and raise without one.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as jentry
from tests import torch_parity as P  # noqa: F401  (sets the torch thread count)
from tinyslam_tpu_torch import entry as tentry
from tinyslam_tpu_torch.models.vo_device import SUMMARY_FIELDS

_COL = {name: i for i, name in enumerate(SUMMARY_FIELDS)}
_LINE = re.compile(
    r"^dryrun_multichip\((\d+)\): mesh=\{'frame': (\d+), 'landmark': (\d+)\} features=(\d+) "
    r"ba_cost=([\d.]+)->([\d.]+) pg_cost=([\d.]+)->([\d.]+) "
    r"pg_node_cost=([\d.]+)->([\d.]+) pg_sim3_cost=([\d.]+)->([\d.]+) "
    r"tracked_summary_shape=\((\d+), (\d+), (\d+)\) backend=(\S+) device=(\S+) \| "
    r"frontend_dp=\d+ms ba_sharded=\d+ms pose_graph_sharded=\d+ms "
    r"pose_graph_node_sharded=\d+ms pose_graph_sim3=\d+ms track_chunk_dp=\d+ms$")


@pytest.fixture(scope="module")
def both():
    jfn, jargs = jentry.entry()
    tfn, targs = tentry.entry(device="cpu")
    return jfn, jargs, tfn, targs


@pytest.fixture(scope="module")
def steps(both):
    jfn, jargs, tfn, targs = both
    _, jys = jax.jit(jfn)(*jargs)
    _, tys = tfn(*targs)
    return np.asarray(jys["summary"]), tys["summary"].numpy()


def test_entry_builds_the_jax_inputs(both):
    _, (jstate, jimage), _, (tstate, timage) = both
    np.testing.assert_array_equal(timage.numpy(), np.asarray(jimage))
    for field in ("X", "valid", "desc", "anchor_kf", "obs_count", "last_seen"):
        np.testing.assert_array_equal(tstate.map.to_numpy()[field],
                                      np.asarray(getattr(jstate.map, field)), err_msg=field)
    assert tstate.map.to_numpy()["desc"].dtype == np.uint32
    assert int(tstate.map.valid.sum()) == 256
    assert bool(tstate.last_tracking) and bool(jstate.last_tracking)
    assert tstate.device == torch.device("cpu")


def test_entry_step_matches_the_jax_step(steps):
    js, ts = steps
    for name in ("num_matches", "num_inliers", "tracking", "is_keyframe", "num_landmarks"):
        assert ts[_COL[name]] == js[_COL[name]], name
    assert ts[_COL["num_landmarks"]] == 256 and ts[_COL["num_matches"]] == 0
    assert abs(ts[_COL["num_features"]] - js[_COL["num_features"]]) <= 0.01 * js[
        _COL["num_features"]]
    np.testing.assert_allclose(ts[_COL["threshold"]], js[_COL["threshold"]], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts[_COL["rmse_px"]], js[_COL["rmse_px"]], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    line = tentry.dryrun_multichip(n, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    m = _LINE.match(line)
    assert m, line
    g = m.groups()
    frame_ax = 2 if n % 2 == 0 else 1
    assert (int(g[0]), int(g[1]), int(g[2])) == (n, frame_ax, n // frame_ax)
    assert int(g[3]) > 0
    for lo, hi in ((4, 5), (6, 7), (8, 9), (10, 11)):      # BA and the three graphs
        assert float(g[hi]) < float(g[lo]), (line, lo)
    assert tuple(int(x) for x in g[12:15]) == (frame_ax, 2, len(SUMMARY_FIELDS))
    assert g[15:] == ("gloo-cpu", "cpu")


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    """Without a card, the entry points raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.dryrun_multichip(2)
