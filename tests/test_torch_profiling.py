"""The port's profiling helpers (``utils/profiling.py``) on the CPU,
mirroring ``tests/test_profiling.py``: ``dispatch_slope`` measures work,
``readback_sync`` takes nested structures, ``trace`` writes a Chrome
trace that names the front-end's per-level scopes."""

from __future__ import annotations

import json

import numpy as np
import torch

from tests import torch_parity as P
from tinyslam_tpu_torch.config import FrontendConfig
from tinyslam_tpu_torch.frontend.orb import extract_features
from tinyslam_tpu_torch.types import Features
from tinyslam_tpu_torch.utils.profiling import (
    dispatch_slope, named_scope, readback_sync, trace,
)


def test_dispatch_slope_measures_work():
    xs = [torch.from_numpy(np.random.default_rng(i).random((256, 256), np.float32))
          for i in range(4)]
    t = dispatch_slope(lambda x: (x @ x).sum(), xs, reps=5, attempts=2)
    assert 0.0 < t < 1.0


def test_readback_sync_accepts_nested_structures():
    readback_sync({"b": (torch.zeros((2, 2)),), "a": [torch.ones(3)]})
    readback_sync(Features.empty(4))
    readback_sync([{"x": 1.0}, (None, torch.arange(3))])
    readback_sync({"nothing": [1, 2]})                  # no tensor: nothing to read


def test_trace_names_the_orb_levels(tmp_path):
    cfg = FrontendConfig(**P.FRONTEND)
    frame = torch.from_numpy(P.orbit(1)[0][0])
    with trace(tmp_path / "tr", device="cpu") as log_dir:
        with named_scope("extract"):
            feats = extract_features(frame, 0.06, cfg)
        readback_sync(feats)
    text = (log_dir / "trace.json").read_text()
    names = {e.get("name") for e in json.loads(text)["traceEvents"]}
    assert {"extract", "orb_level0", "orb_level1"} <= names


def test_trace_without_a_device_needs_the_card(tmp_path, monkeypatch):
    """``trace()`` with no device traces the card; where there is none it
    raises instead of tracing the CPU, and writes nothing."""
    import pytest

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(tmp_path / "tr"):
            pass
    assert not (tmp_path / "tr").exists()


def test_trace_of_nothing_raises(tmp_path):
    """``cpu=False`` on a CPU device would trace nothing: it raises and
    writes nothing."""
    import pytest

    with pytest.raises(ValueError, match="traces nothing"):
        with trace(tmp_path / "tr", device="cpu", cpu=False):
            pass
    assert not (tmp_path / "tr").exists()
