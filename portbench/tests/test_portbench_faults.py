"""A run whose timed path is broken underneath comes out not correct:
once for each fault a cell can have (`portbench/faults.py`)."""

from __future__ import annotations

import pytest

from conftest import run_small, small_cell
from portbench.faults import FAULTS, planted

CASES = [(name, fault) for name, kind in
         (("bunny69k.c512.near", "orbit"), ("bunny69k.c512.far", "orbit"),
          ("armadillo346k-f16.c1024.progressive", "progressive"),
          ("armadillo346k-f16.c1024.adam", "adam"))
         for fault in FAULTS[kind]]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_run_is_not_correct(name, fault):
    cell = small_cell(name)
    with planted(cell.traffic["kind"], fault):
        out = run_small(cell)
    assert not out["correct"], out["checks"]
    assert run_small(cell)["correct"]  # and the fault is gone again
