"""On the card: the control (the reference with TF32 matrix products in the
program's place) comes out not correct, and the program itself correct, on
a small cell.  The cells' own controls at their full sizes are in PERF.md."""

import pytest

from slambench.tests.small import small
from slambench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mh01_fleet8"])
def test_control_is_not_correct(card, name):
    w, c = small(name)
    w["check"]["chunks"] = 4
    args = dict(device=card, workload=w, config=c, spec={"end_to_end": [], "per_layer": []})
    sound = harness.run_cell(name, 3000000001, 3.0, False, **args)
    control = harness.run_cell(name, 3000000001, 3.0, False, control="tf32", **args)
    assert sound["correct"], sound["compared"]
    assert not control["correct"], control["compared"]
