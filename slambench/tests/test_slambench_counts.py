"""The roofline counts equal ``chip_smoke.py`` phase 7's at its shapes: the
bounds in microseconds of the kernel table in PERF.md."""

import json

import pytest

from slambench import harness

PEAKS = json.loads((harness.ROOT / "peaks.json").read_text())
K1 = harness.load_module("counts", "k1")
K2 = harness.load_module("counts", "k2")


def levels(h, w, n=4):
    return [(h >> i, w >> i) for i in range(n)]


@pytest.mark.parametrize("shape, frames, bound_us", [
    ((480, 640), 1, 2.92), ((480, 752), 1, 3.43), ((480, 640), 8, 23.38),
    ((480, 640), 4, 11.69)])
def test_k1_bound_equals_phase_7(shape, frames, bound_us):
    thresholds = frames if frames == 4 else 1          # phase 7's 4 x 640x480 has one a frame
    got = K1.least_s(levels(*shape), PEAKS, frames=frames, thresholds=thresholds) * 1e6
    assert round(got, 2) == bound_us


def test_k1_flops_per_pixel_is_phase_7s():
    assert K1.FLOPS_PER_PIXEL == 16 * 9 + 1 + 28 + 54 + 26 + 8


@pytest.mark.parametrize("n, m, batch, guided, bound_us", [
    (2048, 8192, 1, True, 4.34), (2048, 8192, 1, False, 4.34), (2048, 2048, 1, False, 1.09),
    (2048, 8192, 4, True, 17.36)])
def test_k2_bound_equals_phase_7(n, m, batch, guided, bound_us):
    got = K2.least_s(n, m, PEAKS, batch=batch, guided=guided) * 1e6
    assert round(got, 2) == bound_us


def test_k2_bytes_count_each_input_and_output_once():
    nbytes, ops = K2.work(2048, 8192)
    assert nbytes == 2048 * 41 + 8192 * 41 + 4 * (3 * 2048 + 8192)
    assert ops == 2 * 2048 * 8192 * 256
