"""The command refuses to run, and prints no result, without a card."""

import subprocess
import sys

import pytest

from slambench import harness


def test_without_a_card_the_run_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "mh01_fleet8",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.CHECKOUT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
