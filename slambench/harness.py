"""The benchmark's driver-independent half: it finds a cell's files by name,
times set-up, runs the cell's traffic driver, reads the metrics and prints
the result line.

A cell is ``workloads/<name>.json``; it names its configuration
(``configs/<config>.json``) and its traffic kind (``traffic/<kind>.py``).
Every metric of ``BENCHMARK.json`` is read by ``metrics/<metric>.py``,
whose ``read(rec)`` takes the run's record and returns a number, or None
where the record holds nothing for it (the metric is then left out).  With
``--trace 0`` a cell reports its end-to-end metrics, with ``--trace 1`` its
per-layer ones.

A traffic driver module defines ``Cell(run)``, which builds and warms the
system under test, with three methods: ``window(seconds)`` (the measured
loop; returns the record), ``traced(rec)`` (the per-layer readings after
the window, the profiler last) and ``release()`` (frees the program's
state, keeps what the comparison needs); and ``compare(run, kept)``, the
comparison's verdict: ``{name: number}``.  A number for which the
workload's ``check.limits`` states a limit is compared with it; the
others are reported as observed, with no limit, and decide nothing.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent          # the benchmark's folder
CHECKOUT = ROOT.parent                          # the checkout it runs from
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "tinyslam_tpu")


def process_start() -> float:
    """The wall-clock time at which this process started (from
    ``/proc/self/stat``; the import of this module where that is not
    readable)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def pin_caches() -> None:
    """Keep every compile cache at a fixed folder inside the checkout. The
    port builds its CUDA library into ``build/tinyslam_tpu_torch/`` there
    by itself."""
    base = CHECKOUT / "build" / "slambench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark may not load: JAX, its libraries, or the JAX package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (metric names hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"slambench: no {kind} file {path.name}")
    spec = importlib.util.spec_from_file_location(f"slambench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(workload: str, trace: bool, spec: dict | None = None) -> list[dict]:
    """The metrics of ``BENCHMARK.json`` (or ``spec``) that ``workload``
    reports: end-to-end ones untraced, per-layer ones traced."""
    if spec is None:
        spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


class Run:
    """One run of one cell: its files, its arguments and its clocks."""

    def __init__(self, workload: dict, config: dict, seed: int, seconds: float,
                 trace: bool, device, control: str | None = None):
        self.workload = workload
        self.config = config
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.control = control
        self.started = process_start()
        self.setup_end = None

    def setup_done(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_end = time.time()

    @property
    def setup_s(self) -> float:
        return self.setup_end - self.started


def device_info(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             workload: dict | None = None, config: dict | None = None,
             spec: dict | None = None, control: str | None = None) -> dict:
    """Run cell ``name`` once and return its result (the line's object).
    ``workload``, ``config`` and ``spec`` replace the files of that name
    (the tests' small set-ups); ``control`` puts the reference at a lower
    precision in the program's place in the comparison."""
    workload = workload or load_json("workloads", name)
    config = config or load_json("configs", workload["config"])
    run = Run(workload, config, seed, seconds, trace, device, control)
    driver = load_module("traffic", workload["traffic"])
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    cell = driver.Cell(run)
    run.setup_done()
    rec = cell.window(run.seconds)
    rec["setup_s"] = run.setup_s
    if trace:
        cell.traced(rec)
    found = forbidden_modules()
    if found:
        raise ImportError(f"slambench: loaded after the window: {', '.join(found)}")
    device = device_info(run.device)
    if trace:
        device["busy_s"] = rec["profile"]["busy_s"]
        device["window_s"] = rec["profile"]["window_s"]
    kept = cell.release()
    del cell
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.compare(run, kept)
    limits = workload["check"]["limits"]
    compared = {k: {"value": float(numbers[k]) if k in numbers else float("nan"),
                    "limit": float(v)} for k, v in limits.items()}
    observed = {k: float(v) for k, v in numbers.items() if k not in limits}
    # A stated number that is missing (NaN) is not correct.
    correct = all(v["value"] <= v["limit"] for v in compared.values()) and bool(compared)
    metrics = {}
    for m in cell_metrics(name, trace, spec):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": correct, "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": device}
    if trace and rec.get("breakdown"):
        out["breakdown"] = rec["breakdown"]
    out["observed"] = observed
    out["compared"] = compared
    return out
