"""pytest settings of the benchmark's own tests (`python -m pytest
benchmark/tests`): the `chip` marker for tests that need the card, and the
tiny CPU cell the others run."""

import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skip the test unless a CUDA card is present (decided here, at run
    time, never at import or collection)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")


@pytest.fixture
def tiny_root(tmp_path):
    """A root holding the tiny CPU cells and configs beside the
    benchmark's own traffic mixes and metric readers."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(HERE, "tests", "tiny"), root)
    for d in ("traffic", "metrics"):
        shutil.copytree(os.path.join(HERE, d), root / d)
    return root
