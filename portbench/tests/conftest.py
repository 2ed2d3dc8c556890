"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
cells are cut to a size the CPU marches in seconds, beside the program.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
Tests marked ``card`` need an NVIDIA card and skip without one.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import pytest
import torch

from tinybench import shrink

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout of the benchmark at a tiny size: ``BENCHMARK.json`` and
    ``portbench/`` copied, the program linked."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "volrt_torch").symlink_to(ROOT / "volrt_torch")
    shrink(tmp_path)
    return tmp_path
