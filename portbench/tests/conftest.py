"""The benchmark's tests. Tests that need a CUDA card carry the `card`
marker and skip inside the `card` fixture, never at import or collection,
so every worker collects the same tests.

    python3 -m pytest portbench/tests -q            # here: card tests skip
    python3 -m pytest portbench/tests -q -m card    # on the card's machine
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this machine")
    return torch.cuda.get_device_name(0)
