"""One short run of each cell through the command line, on the card:
`python -m pytest portbench/tests -m card` on a machine with an NVIDIA
GPU.  Skipped elsewhere."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from test_portbench_cells import CELLS


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "4000000007", "--seconds", "8", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu", out
