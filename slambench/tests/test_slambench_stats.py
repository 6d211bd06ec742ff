"""The end-to-end arithmetic over all chunks of a window."""

import pytest

from slambench import harness
from slambench.stats import Reservoir, rate


def test_rate_over_the_whole_window():
    assert rate(3000, 20.0) == 150.0
    # A window with a stall: the rate is all tracked frames over all of it.
    rec = {"tracked": 3000, "window_s": 20.0}
    assert harness.load_module("metrics", "tracked_fps").read(rec) == 150.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_idle_share_and_card_time_over_the_window():
    rec = {"window_s": 2.0, "steps": 32, "chunk_card_ms": [600.0, 900.0]}
    assert harness.load_module("metrics", "device.idle_share").read(rec) == 25.0
    assert harness.load_module("metrics", "fleet.card_ms_per_step").read(rec) == 1500.0 / 32


def test_readers_leave_out_what_they_cannot_read():
    for name in ("k1_roofline", "k2_roofline", "device.idle_share", "fleet.card_ms_per_step"):
        assert harness.load_module("metrics", name).read({"attempted": 0}) is None


def test_reservoir_is_fixed_by_the_seed():
    def draw(seed):
        r = Reservoir(3, seed)
        for i in range(100):
            r.offer(lambda i=i: i)
        return r.items

    assert draw(3000000001) == draw(3000000001)
    assert len(draw(5)) == 3 and len(set(draw(5))) == 3


def test_numbers_without_a_limit_are_observed_and_decide_nothing(monkeypatch):
    from slambench.tests.small import SPEC, small

    w, c = small("mh01_fleet8")
    driver = harness.load_module("traffic", "fleet")
    monkeypatch.setattr(harness, "load_module",
                        lambda kind, name, real=harness.load_module:
                        driver if kind == "traffic" else real(kind, name))
    monkeypatch.setattr(driver, "compare",
                        lambda run, kept: {"gt_turn_deg": 40.0, "pose_gap": 0.0})
    out = harness.run_cell("mh01_fleet8", 3000000001, 0.5, False, device="cpu", workload=w,
                           config=c, spec=SPEC)
    assert out["observed"] == {"gt_turn_deg": 40.0}
    # count_gap has a limit and no number: missing, so not correct.
    assert out["compared"]["pose_gap"] == {"value": 0.0, "limit": 0.0005}
    assert not out["correct"]
    assert list(out)[-1] == "compared"
