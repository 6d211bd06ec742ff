"""Every configuration, workload, traffic kind, metric and count is a file of
its own, found by its name, and ``BENCHMARK.json`` names only such files."""

import json
import re

import pytest

from slambench import harness

SPEC = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _names(kind, suffix):
    return sorted(p.name[: -len(suffix)] for p in (harness.ROOT / kind).glob(f"*{suffix}"))


@pytest.mark.parametrize("name", _names("configs", ".json"))
def test_config_loads(name):
    c = harness.load_json("configs", name)
    assert c["name"] == name and c["source"] and c["assumed"]
    assert {"fx", "fy", "cx", "cy", "width", "height"} <= set(c["camera"])
    from tinyslam_tpu_torch.config import SlamConfig

    assert json.loads(SlamConfig.from_json(json.dumps(c["slam"])).to_json()) == c["slam"]


@pytest.mark.parametrize("name", _names("workloads", ".json"))
def test_workload_loads(name):
    w = harness.load_json("workloads", name)
    assert w["name"] == name
    harness.load_json("configs", w["config"])
    driver = harness.load_module("traffic", w["traffic"])
    assert callable(driver.Cell) and callable(driver.compare)
    assert set(w["check"]["limits"]) and all(v >= 0 for v in w["check"]["limits"].values())


@pytest.mark.parametrize("name", _names("metrics", ".py"))
def test_metric_reader_loads(name):
    assert callable(harness.load_module("metrics", name).read)


@pytest.mark.parametrize("name", _names("counts", ".py"))
def test_count_loads(name):
    mod = harness.load_module("counts", name)
    assert callable(mod.work) and callable(mod.least_s)


def test_benchmark_names_files_that_exist():
    cells = {w["name"] for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert (harness.CHECKOUT / c["file"]).is_file()
        assert harness.load_json("configs", c["name"])["source"]
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert harness.load_json("workloads", w["name"])["config"] == w["config"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in SPEC["end_to_end"]} == {"tracked_fps", "setup_s"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        # Every cell that reports a per-layer metric reports what it moves.
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(w["name"], False, SPEC)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(w["name"], True, SPEC)
