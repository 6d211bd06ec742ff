"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the port.  Top-level module names are compared whole:
``tinyslam_tpu_torch`` begins with ``tinyslam_tpu``."""

import ast
import json
import subprocess
import sys

from slambench import harness

REF = harness.ROOT / "reference"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_reference_sources_import_nothing_of_the_port():
    files = sorted(REF.rglob("*.py"))
    assert files
    for f in files:
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & {"tinyslam_tpu_torch", *harness.FORBIDDEN}, f


def test_no_source_of_the_benchmark_imports_jax():
    for f in sorted(harness.ROOT.rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & set(harness.FORBIDDEN), f


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.CHECKOUT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_no_module_of_the_port():
    got = _run("import json, sys; from slambench import check; check.reference(); "
               "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "tinyslam_tpu_torch" not in got
    assert not set(got) & set(harness.FORBIDDEN)


def test_a_cell_after_its_set_up_loads_no_jax():
    got = _run(
        "import json, sys; from slambench import harness; from slambench.tests.small import small\n"
        "w, c = small('mh01_fleet8')\n"
        "run = harness.Run(w, c, 3000000001, 1.0, False, 'cpu')\n"
        "cell = harness.load_module('traffic', w['traffic']).Cell(run)\n"
        "print(json.dumps(harness.forbidden_modules()))")
    assert got == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tinyslam_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert "tinyslam_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tinyslam_tpu.models", sys)
    assert "tinyslam_tpu" in harness.forbidden_modules()
