"""Fixtures of the benchmark's tests: a copy of ``port_bench/`` with the
test-only tiny files (``tests/data``) added, which ``PORT_BENCH_ROOT``
points the harness at; and the ``card`` marker for tests that need a CUDA
card (they skip here; on the card: ``python3 -m pytest port_bench/tests -m
card``)."""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of the benchmark's data with the tiny test files added."""
    root = tmp_path / "port_bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for kind in ("configs", "traffic", "workloads"):
        for f in (HERE / "data" / kind).glob("*.json"):
            shutil.copy(f, root / kind / f.name)
    monkeypatch.setenv("PORT_BENCH_ROOT", str(root))
    return root
