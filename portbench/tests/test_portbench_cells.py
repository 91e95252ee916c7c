"""The harness finds a cell, a configuration, a traffic mix and a
per-layer metric from files and entries alone, and refuses to run where
it must."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import harness

CELLS = ["bunny69k.c512.near", "armadillo346k-f16.c1024.adam",
         "bunny69k.c512.far", "armadillo346k-f16.c1024.progressive",
         "multimesh515k.c1080.bounce2", "suzanne15k.brute256.api"]


@pytest.mark.parametrize("name", CELLS)
def test_cells_load_from_their_files(name):
    cell = harness.load_cell(name, ROOT)
    assert cell.chips == 1
    assert cell.config["precision"] == "float32"
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_a_cell_a_config_a_mix_and_a_metric_are_files_and_entries(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "portbench"
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "bunny69k.c512.json").read_text())
    config.update(name="bunny69k.c256", width=256, height=256)
    (bench / "configs" / "bunny69k.c256.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "near.json").read_text())
    mix["distance"] = [1.5, 1.6]
    (bench / "traffic" / "close.json").write_text(json.dumps(mix))
    (bench / "limits" / "bunny69k.c256.close.json").write_text(
        '{"px_off": 0.001}')
    (bench / "metrics" / "units.frame.py").write_text(
        "def read(trace):\n    return float(trace.units)\n")
    spec["configs"].append(dict(spec["configs"][0], name="bunny69k.c256",
                                file="portbench/configs/bunny69k.c256.json"))
    spec["workloads"].append({"name": "bunny69k.c256.close",
                              "config": "bunny69k.c256", "traffic": "close",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "bunny69k.c512.near" in m["workloads"]:
            m["workloads"].append("bunny69k.c256.close")
    spec["per_layer"].append({"name": "units.frame", "unit": "frames",
                              "better": "higher", "source": "device_trace",
                              "layer": "Frame glue", "moves": "frame_ms",
                              "workloads": ["bunny69k.c256.close"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    probe = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from pathlib import Path\n"
        "from portbench import harness, tracing\n"
        "assert harness.__file__.startswith(sys.argv[1])\n"
        "c = harness.load_cell('bunny69k.c256.close', Path(sys.argv[1]))\n"
        "assert c.config['width'] == 256 and c.traffic['distance'] == [1.5, 1.6]\n"
        "assert [m['name'] for m in c.per_layer] == ['units.frame']\n"
        "assert {m['name'] for m in c.end_to_end} == "
        "{'frame_ms', 'frame_p95_ms', 'setup_s'}\n"
        "t = tracing.TraceData(7, 1.0, 0.5, [], [], {}, {})\n"
        "assert tracing.load_reader('units.frame').read(t) == 7.0\n")
    done = subprocess.run([sys.executable, "-c", probe, str(tmp_path),
                           str(ROOT)], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr


def _run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bunny69k.c512.near", "--seed", str(2 ** 31 + 12345), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=300)


def test_no_gpu_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    done = _run_cli(ROOT)
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA" in done.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _run_cli(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
