"""CPU tests of the benchmark (``python -m pytest slambench/tests``).  Tests
that need the card carry the ``cuda`` marker and skip inside a fixture
where there is none."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's TF32 products exist only there")
    return torch.device("cuda")
