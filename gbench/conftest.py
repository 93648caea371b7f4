"""pytest settings of the benchmark's own tests (``pytest gbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and ask for the
``card`` fixture, which skips them where no card is visible; on the chip
run ``python3 -m pytest gbench/tests -m card``. Whether a card is there
is decided inside the fixture, never while a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip with -m card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
