"""A run whose timed path is broken underneath comes out not correct: the
harness is driven as on the card (without its look for one), on a tiny
cell on the CPU, with one fault of ``portbench/faults.py`` planted in the
port for the run."""

import pytest

from portbench import faults
from portbench.tests import cells


@pytest.mark.parametrize("cell,fault", faults.FAULTS, ids=[f.__name__ for _, f in faults.FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out, _ = cells.run(cell, seconds=1.0)
    assert out["correct"] is False, out["checks"]
