"""The control of the comparison: the reference computed with its state
held in bfloat16 (the precision below the configurations' f32), put in the
system's place, must come out not correct."""

import pytest

from perfbench import compare, harness
from perfbench.tests.cells import ALL as BENCH, CELLS


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_cpu_size(name):
    """40 frames of the cell's stream (4 lanes of 30 frames in batch)."""
    cell = harness.Cell(name, BENCH)
    t = dict(cell.traffic, frames=40, reference_workers=1)
    if t["entry"] == "run_batch":
        t.update(frames=30, textures=2, offsets=2, sample={"block": 2, "per_block": 1})
    cell.traffic = t
    (got,) = harness.control(cell, [2 ** 31 + 5], "cpu")
    ok, shown = compare.verdict(got, cell.limits)
    assert not ok, shown


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cell_size(name, card):
    """The cell's own stream, on the card, three seeds."""
    cell = harness.Cell(name, BENCH)
    for got in harness.control(cell, [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103], card):
        ok, shown = compare.verdict(got, cell.limits)
        assert not ok, (got["seed"], shown)
