#
# pytest settings of the benchmark's own tests (python -m pytest
# portbench/tests).  A test that needs an NVIDIA card carries the `card`
# marker and takes the `card` fixture, which decides at run time whether
# there is one and skips with the reason where there is not.
#

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (runs on the chip, skips elsewhere)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
