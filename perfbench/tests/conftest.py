"""The benchmark's own tests. Those that need a CUDA card carry the `chip`
marker and skip elsewhere; whether there is a card is decided inside the
`card` fixture, never while a module is imported. Run them all with

    python -m pytest perfbench/tests -q

from the root of the repository (on a machine with a card, the `chip`
tests run too)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
