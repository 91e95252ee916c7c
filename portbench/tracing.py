"""The traced slice of a ``--trace 1`` run, and the per-layer metrics read
from it.

In a traced run `torch.profiler` records the first ``trace_units`` units
(frames, passes or steps: one period of the traffic) of the window; the
rest of the window runs untraced.  Beside the profiler the harness
records its own spans (CUDA events around its calls into a layer, such
as ``backward()``), and a metric's reader may count the inputs of the
program's launch wrappers while the slice runs.

A per-layer metric is the file ``portbench/metrics/<name>.py``: a
``read(trace) -> float | None`` that takes the `TraceData` of the slice
and returns None when it finds nothing to read, and optionally an
``install(tracer)`` that the harness calls before the slice.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib.util
from pathlib import Path
from typing import NamedTuple

import torch

METRICS = Path(__file__).resolve().parent / "metrics"
#: The profiler's marker of the traced window.
WINDOW = "portbench.window"


def short_name(name: str) -> str:
    """A device activity's name without return type, namespace and
    parameter list: ``sweep_items_kernel<false, true>``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0]


class Call(NamedTuple):
    tests: torch.Tensor  # ray-triangle tests the launch needs (a 0-d tensor)
    nbytes: int  # bytes of its inputs and outputs


class TraceData(NamedTuple):
    units: int  # frames, passes or steps traced
    window_s: float  # the traced window
    busy_s: float  # union of device activity within it
    activities: list  # (short name, start us, duration us) on the device
    gaps: list  # (host operation under the gap, seconds) per idle gap
    spans: dict  # harness span name -> [ms, ...]
    calls: dict  # launch wrapper -> [Call, ...]


def load_reader(name: str):
    """The module of per-layer metric ``name``."""
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Tracer:
    """Spans, launch counts and the profiler over one slice of the
    window.  Outside the slice every method is a no-op."""

    def __init__(self, device: torch.device, readers=()):
        self.device = device
        self.readers = list(readers)
        self.active = False
        self.spans = collections.defaultdict(list)
        self.calls = collections.defaultdict(list)
        self._patches = []
        self._prof = None
        self._mark = None

    def patch(self, module, attr: str, fn) -> None:
        """Replace ``module.attr`` by ``fn`` for the slice (once)."""
        if any(m is module and a == attr for m, a, _ in self._patches):
            return
        self._patches.append((module, attr, getattr(module, attr)))
        setattr(module, attr, fn)

    def count(self, wrapper: str, tests: torch.Tensor, nbytes: int) -> None:
        if self.active:
            self.calls[wrapper].append(Call(tests, nbytes))

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        try:
            yield
        finally:
            end.record()
            self.spans[name].append((begin, end))

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        for reader in self.readers:
            if hasattr(reader, "install"):
                reader.install(self)
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._mark = record_function(WINDOW)
        self._mark.__enter__()
        self.active = True

    def stop(self, units: int) -> TraceData:
        torch.cuda.synchronize(self.device)
        self.active = False
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        for module, attr, fn in reversed(self._patches):
            setattr(module, attr, fn)
        self._patches.clear()
        spans = {k: [b.elapsed_time(e) for b, e in v]
                 for k, v in self.spans.items()}
        return reduce_events(self._prof.profiler.kineto_results.events(),
                             units, spans, dict(self.calls))


def _union(intervals) -> list:
    """Merged ``(start, end)`` intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_op(ops, starts, t: float) -> str:
    """The innermost host operation running at ``t`` (``ops`` sorted by
    start), or ``python`` where none is."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return "python"


def reduce_events(events, units: int, spans: dict, calls: dict) -> TraceData:
    """`TraceData` from the profiler's raw events (``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``)."""
    from torch.autograd import DeviceType

    device, host = [], []
    window = None
    for e in events:
        name = e.name()
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if name == WINDOW:
            if e.device_type() == DeviceType.CPU:
                window = (start, end)
        elif e.device_type() == DeviceType.CUDA:
            device.append((short_name(name), start, end))
        else:
            host.append((start, end, name))
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    lo, hi = window
    busy = _union((max(s, lo), min(e, hi)) for _, s, e in device
                  if e > lo and s < hi)
    host.sort()
    starts = [h[0] for h in host]
    gaps = []
    edge = lo
    for s, e in busy + [[hi, hi]]:
        if s > edge:
            gaps.append((_host_op(host, starts, (edge + s) / 2),
                         (s - edge) / 1e6))
        edge = max(edge, e)
    return TraceData(
        units=units, window_s=(hi - lo) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        activities=[(n, s, e - s) for n, s, e in device], gaps=gaps,
        spans=spans, calls=calls)


def breakdown(trace: TraceData) -> dict:
    """The device operations that took most time and the longest idle
    time by what the host was doing, ten of each, in seconds."""
    ops = collections.Counter()
    for name, _, dur in trace.activities:
        ops[name] += dur / 1e6
    idle = collections.Counter()
    for name, sec in trace.gaps:
        idle[name] += sec
    return {"device_ops": [[n, s] for n, s in ops.most_common(10)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}


def kernel_ms(trace: TraceData, names) -> float:
    """Device ms of the activities whose name, or whose name up to its
    template arguments, is in ``names``."""
    names = set(names)
    return sum(dur for n, _, dur in trace.activities
               if n in names or n.split("<")[0] in names) / 1e3
