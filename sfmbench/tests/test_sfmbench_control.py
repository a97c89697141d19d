"""The check fails what it must: the control (the reference in the
program's place, one precision lower) comes out not correct, and a run
with the timed path broken underneath comes out not correct for each
fault the cell can have. At the cells' test sizes on the CPU; the same
on the card at the cells' own sizes is `python3 -m sfmbench.calibrate`."""

import time

import pytest
import torch

from sfmbench import faults, harness
from sfmbench.tests.conftest import ROOT, TINY


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct(name, seed):
    cell = harness.Cell(ROOT, name, TINY[name])
    st = cell.runner.setup(cell.config, cell.mix, seed, torch.device("cpu"))
    checks, _ = cell.runner.control(st, seed)
    assert any(v > lim for _, v, lim in checks), checks


@pytest.mark.parametrize("name,fault", [
    (n, f.__name__) for n in sorted(TINY)
    for f in faults.FAULTS[harness.Cell(ROOT, n).mix["runner"]]])
def test_fault_is_not_correct(name, fault, capsys):
    cell = harness.Cell(ROOT, name, TINY[name])
    with getattr(faults, fault)():
        out = harness.run_cell(cell, 4, 0.1, False, torch.device("cpu"),
                               time.perf_counter())
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


def test_on_the_card(cuda):
    """Each cell at its test size through the card's path (K1 and the
    solver on the device) comes out correct, and its control not."""
    for name in sorted(TINY):
        cell = harness.Cell(ROOT, name, TINY[name])
        out = harness.run_cell(cell, 5, 0.5, True, cuda, time.perf_counter())
        assert out["correct"], out["checks"]
        assert out["device"]["busy_s"] > 0
        st = cell.runner.setup(cell.config, cell.mix, 5, cuda)
        checks, _ = cell.runner.control(st, 5)
        assert any(v > lim for _, v, lim in checks), checks
