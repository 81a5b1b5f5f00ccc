"""The control, the reference in bfloat16 in the program's place, comes out not correct.

On the CPU at a size a test run holds (256 peers; blocks of 64); on the
card at the cell's own size, three seeds each, with ``-m cuda`` (the
benchmark's own runs never run the control)."""

import pytest

from portbench import spec
from portbench.control import control_factory, readings
from portbench.tests.conftest import run_small, small_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_small_n(workload):
    cell = small_cell(workload, 256)
    if cell.config["engine"]["tick"] == "blocked":
        cell.config["engine"]["block"] = 64
    for seed in (1, 2, 3):
        result, shown = run_small(workload, control_factory, seed=seed, cell=cell)
        assert not result["correct"], (seed, shown)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_cell_size(workload, card):
    cell = spec.find_cell(workload)
    seconds = spec.load_benchmark()["run_seconds"]
    for row in readings(cell, (101, 202, 303), seconds, control_factory, card):
        assert not row["correct"], row
