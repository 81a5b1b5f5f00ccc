"""Small versions of the benchmark's cells for the CPU tests, and the card's fixture."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402

SMALL_N = 64
SMALL_BLOCK = 16


def small_cell(workload: str, n: int = SMALL_N):
    """The cell ``workload`` of BENCHMARK.json at ``n`` peers (blocks of 16)."""
    cell = copy.deepcopy(spec.find_cell(workload))
    cell.config["n"] = n
    if cell.config["engine"]["tick"] == "blocked":
        cell.config["engine"]["block"] = SMALL_BLOCK
    return cell


def run_small(workload: str, factory, seed: int = 2**31 + 5, seconds: float = 0.5,
              trace: bool = False, cell=None):
    from portbench.run import run_cell

    return run_cell(cell or small_cell(workload), seed, seconds, trace, factory, "cpu",
                    time.time())


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest portbench/tests -m cuda)")
    return "cuda:0"
