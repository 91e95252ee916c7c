"""Shared fixtures of the benchmark's CPU tests: cells of
``BENCHMARK.json`` shrunk to a size the CPU runs in seconds, through the
program's plain PyTorch versions."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

# One intra-op thread a test process: the tests run in several at once,
# and a window must hold a whole period of the small traffic.
torch.set_num_threads(1)
CPU = torch.device("cpu")
#: Each configuration's meshes at a CPU's size: (faces, frame side).
SMALL = {"bunny69k.c512": ((2000,), 48),
         "armadillo346k-f16.c1024": ((300, 3000), 48),
         "multimesh515k.c1080": ((600, 3000, 1500), 48),
         "suzanne15k.brute256": ((500,), 32)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; run on the card with "
        "`python -m pytest portbench/tests -m card`")


def small_cell(name: str) -> harness.Cell:
    """Cell ``name`` with fewer faces, a smaller frame and shorter
    traffic; every other number as in its files."""
    cell = harness.load_cell(name, ROOT)
    config = copy.deepcopy(cell.config)
    faces, side = SMALL[config["name"]]
    for mesh, n in zip(config["meshes"], faces):
        mesh["faces"] = n
    config["width"] = config["height"] = side
    traffic = dict(cell.traffic)
    traffic.update({"orbit": {"period": 4, "pan_deg_per_frame": 90.0,
                              "checked_frames": 2, "warmup_frames": 1,
                              "trace_units": 4},
                    "bounce_orbit": {"period": 4, "pan_deg_per_frame": 90.0,
                                     "checked_frames": 2, "warmup_frames": 1,
                                     "trace_units": 4, "sample_px": 1000},
                    "api_orbit": {"period": 4, "pan_deg_per_frame": 90.0,
                                  "checked_frames": 2, "warmup_frames": 1,
                                  "trace_units": 4},
                    "progressive": {"passes": 2, "warmup_passes": 1,
                                    "trace_units": 2},
                    "adam": {"job_steps": 4, "trace_units": 2}}
                   [traffic["kind"]])
    return cell._replace(config=config, traffic=traffic)


def run_small(cell: harness.Cell, seed: int = 5,
              seconds: float = 4.0) -> dict:
    return harness.run(cell, seed, seconds, False, CPU, time.perf_counter())


@pytest.fixture(params=["bunny69k.c512.near", "bunny69k.c512.far",
                        "armadillo346k-f16.c1024.progressive",
                        "armadillo346k-f16.c1024.adam"])
def cell_name(request):
    return request.param
