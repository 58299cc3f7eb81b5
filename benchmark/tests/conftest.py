"""The benchmark's own tests (CPU; a test that needs a card takes the
`cuda` fixture and skips without one):

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (HERE, BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
