"""The control: the reference put in the program's place and computed in
bfloat16, the nearest precision below the configurations' float32, reads
above every cell's limits, where the program reads within them."""

from __future__ import annotations

import pytest

from conftest import CPU, run_small, small_cell
from portbench import checks
from portbench.kinds import KINDS


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_control_fails_and_program_passes(cell_name, seed):
    cell = small_cell(cell_name)
    kind = KINDS[cell.traffic["kind"]](cell.config, cell.traffic, seed, CPU)
    kind.release()
    control = kind.control()
    assert not checks.verdict(control, cell.limits), control
    out = run_small(cell, seed)
    assert out["correct"], out["checks"]
