"""The comparison fails where it must: the control (the reference one
precision lower in the program's place) and every fault planted under
the timed path come out not correct, at tiny sizes on the CPU."""

import pytest

import bench_tiny
from benchmark import faults

CELLS = bench_tiny.WALK_CELLS + ("heg14.shci",)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = bench_tiny.run(cell, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS
    for fault in faults.FOR["shci" if cell.endswith("shci") else "walk"]])
def test_a_planted_fault_is_not_correct(cell, fault):
    kind = "shci" if cell.endswith("shci") else "walk"
    r = bench_tiny.run_with_fault(cell, faults.FOR[kind][fault])
    assert not r["correct"], r["checks"]
