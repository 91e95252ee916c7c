"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result line.

A cell is found by name in ``BENCHMARK.json``: it names a configuration
(its file) and a traffic mix (``portbench/traffic/<traffic>.json``); its
limits are ``portbench/limits/<cell>.json`` and its per-layer metrics
``portbench/metrics/<metric>.py``.  Adding a cell, a configuration, a
traffic mix, a traffic kind (`kinds.kind_class`) or a per-layer metric
adds files and entries only.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

from . import checks
from .kinds import kind_class, sync
from .tracing import Tracer, breakdown, load_reader

BENCH = Path(__file__).resolve().parent
#: Top-level modules that no run may load: JAX, and the JAX package the
#: program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracercuda_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the metric entries a ``--trace 0`` run reports
    per_layer: list  # those of a ``--trace 1`` run


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def read(path: Path) -> dict:
        return json.loads(path.read_text())

    def applies(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(name=name, chips=cell["chips"], config=read(root / entry["file"]),
                traffic=read(BENCH / "traffic" / f"{cell['traffic']}.json"),
                limits=read(BENCH / "limits" / f"{name}.json"),
                end_to_end=[m for m in spec["end_to_end"] if applies(m)],
                per_layer=[m for m in spec["per_layer"] if applies(m)])


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of `FORBIDDEN`."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> dict:
    """Run ``cell`` once; returns the result line's object.  ``t_start``
    is the process's start on the `time.perf_counter` clock."""
    kind = kind_class(cell.traffic["kind"])(cell.config, cell.traffic, seed,
                                            device)
    kind.warm_up()
    readers = ({m["name"]: load_reader(m["name"]) for m in cell.per_layer}
               if trace else {})
    tracer = Tracer(device, readers.values())
    gc.collect()
    gc.freeze()
    sync(device)

    traced_units = cell.traffic["trace_units"]
    latencies = []
    begin = time.perf_counter()
    setup_s = begin - t_start
    deadline = begin + seconds
    trace_data = None
    while time.perf_counter() < deadline or (trace and trace_data is None):
        if trace and len(latencies) == 0:
            tracer.start()
        issued = time.perf_counter()
        kind.unit(len(latencies), tracer)
        latencies.append(time.perf_counter() - issued)
        if trace and len(latencies) == traced_units:
            trace_data = tracer.stop(traced_units)
    sync(device)
    window_s = time.perf_counter() - begin
    gc.unfreeze()

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = time.perf_counter()
    readings = kind.check()
    print(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.2f} s, "
          f"{len(latencies)} units in {window_s:.2f} s, check "
          f"{time.perf_counter() - checked:.2f} s; {kind.notes()}",
          file=sys.stderr)

    values = kind.end_to_end(window_s, latencies)
    values["setup_s"] = setup_s
    if trace:
        values = {name: reader.read(trace_data)
                  for name, reader in readers.items()}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in (cell.per_layer if trace else cell.end_to_end)
               if values.get(m["name"]) is not None}
    out = {"correct": checks.verdict(readings, cell.limits),
           "attempted": len(latencies), "failed": 0, "metrics": metrics,
           "device": device_info(device, peak)}
    if trace:
        out["device"]["busy_s"] = trace_data.busy_s
        out["device"]["window_s"] = trace_data.window_s
        out["breakdown"] = breakdown(trace_data)
    out["checks"] = {name: {"value": readings.get(name, math.inf),
                            "limit": limit}
                     for name, limit in cell.limits.items()}
    return out


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}
