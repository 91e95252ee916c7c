"""The port's tracing: program spans and counters, the per-phase frame
profiler and `device_trace`.

Program tracing (`span`, `host_sync`, `count`, `collect`) is off by
default.  Off, `span` reads one module global and returns a shared no-op
object: it allocates, synchronises and records nothing.  On (`tracing`,
`device_trace`, or the benchmark setting ``enabled``), each span keeps
``(id, name, start_ns, end_ns, parent, unit)`` in memory: the parent is
the innermost span open on the same thread, a span with no parent is a
root (a frame, a progressive pass, a step's ``accel.build``, ``render``
and ``grad``), and every span carries its root's id as ``unit``.  Each
thread has its own stack of open spans, since autograd runs backward
functions on a worker thread of its own.  Spans are stamped with
`time.time_ns`, the epoch clock on which `torch.profiler` (kineto) stamps
its host and device events, so a span lies beside the profiler's device
activities without conversion.  Nothing is written while the program
runs: `collect` hands over the spans and counters and clears them.

The spans the routes record:

  * a CLUSTER frame (`trace/frame.py`): ``frame`` > ``frame.rays``,
    ``sweep.cull``, ``sweep.A``, ``frame.shadow_rays``,
    ``sweep.shadow_cull``, ``sweep.B``, ``frame.shade``;
  * an LBVH frame (BVH, or WAVEFRONT without ``bvh.L``): ``frame`` >
    ``frame.rays``, ``bvh.L`` (`trace_beam`, kernel L, holding
    ``sync.beam``), ``frame.shadow_rays``, ``bvh.K`` (`any_hit_bvh`,
    kernel K), ``frame.shade``; ``bvh.L`` and ``bvh.K`` (also
    `trace_bvh`) wherever those functions are called;
  * the differentiable render (`diff/render_grad.py`): ``render`` >
    ``render.discrete`` (``sweep.cull``, ``sweep.C``,
    ``sweep.shadow_cull``, ``sweep.H``) and ``render.shade``, under
    ``pass`` in `progressive_step`; its backward ``grad`` (with
    ``grad.recompute`` and ``grad.autograd`` in `_RenderVJP`) holding
    ``scatter.G``, and in `render_rgb_silhouette`'s ``grad.boundary``
    (``boundary.samples``, ``sync.live_samples``, ``boundary.probes``,
    ``boundary.project``; counters ``boundary_live_samples``,
    ``boundary_probes``); ``accel.build`` in `build_clusters` and
    `build_bvh`;
  * ``sync.<site>`` where a route waits for the device, each wait also
    counted under ``host_syncs``: ``sync.beam`` around each call of
    kernel L's C entry, which waits once a batch of rounds and adds its
    own count of waits.

`Profiler` is the ``ProfileItem`` analog (`TestProgram/Program.h:21-32`,
`Program.cpp:358-379`; counterpart of `raytracercuda_tpu/utils/
profiler.py`): named phase stopwatches pushed per frame, dumped once per
second; each phase is also a span.  A phase given CUDA tensors through
``sync`` ends with `torch.cuda.synchronize` on their device, so it times
the card's work and not its enqueue.  `device_trace` captures a
`torch.profiler` trace around any block with program tracing on, exported
as a Chrome trace (viewable in Perfetto) that holds the program's spans
as a host track above the kernels.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

#: Program tracing on (True) or off: the one global `span`, `host_sync`
#: and `count` read.
enabled = False


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int  # `time.time_ns`
    end_ns: int
    parent: int | None  # id of the span open around it on its thread
    unit: int  # id of its root span (its own id for a root)


class Record(NamedTuple):
    spans: list  # [Span], in the order they ended
    counters: dict  # name -> total


_spans: list = []
_counters: collections.Counter = collections.Counter()
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span `span` returns while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def open(self) -> "_Off":
        return self

    def close(self) -> None:
        pass


_OFF = _Off()


class _On:
    """A span being recorded.  ``with`` opens and closes it; `open` and
    `close` do the same where the two ends are in different calls (the
    backward of a render)."""

    __slots__ = ("name", "id", "parent", "unit", "start_ns", "stack")

    def __init__(self, name: str):
        self.name = name

    def open(self) -> "_On":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        else:
            self.parent, self.unit = None, self.id
        self.stack = stack
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def close(self) -> None:
        end = time.time_ns()
        if self.stack and self.stack[-1] is self:
            self.stack.pop()
        elif self in self.stack:
            self.stack.remove(self)
        # A plain tuple, cheaper to keep than the `Span` `collect` makes.
        _spans.append((self.id, self.name, self.start_ns, end, self.parent,
                       self.unit))

    __enter__ = open

    def __exit__(self, *exc):
        self.close()


def span(name: str):
    """A context manager that records span ``name`` while tracing is on."""
    if not enabled:
        return _OFF
    return _On(name)


def host_sync(name: str, n: int = 1):
    """`span` ``name`` (``sync.<site>``) around ``n`` calls that wait for
    the device (a device-to-host read, a copy from pageable host memory),
    counted under ``host_syncs``."""
    if not enabled:
        return _OFF
    count("host_syncs", n)
    return _On(name)


def count(name: str, n: int = 1) -> None:
    """Add host integer ``n`` to counter ``name`` while tracing is on."""
    if enabled:
        with _lock:
            _counters[name] += n


def collect() -> Record:
    """The spans ended and the counters added since the last call, which
    are then cleared."""
    global _spans
    with _lock:
        spans, _spans = _spans, []
        counters = dict(_counters)
        _counters.clear()
    return Record([Span._make(s) for s in spans], counters)


@contextlib.contextmanager
def tracing():
    """Program tracing on for the block."""
    global enabled
    was = enabled
    enabled = True
    try:
        yield
    finally:
        enabled = was


@dataclass
class ProfileItem:
    name: str
    start: float = 0.0
    end: float = 0.0

    @property
    def elapsed_ms(self) -> float:
        return (self.end - self.start) * 1000.0


def _cuda_devices(sync) -> set:
    """The CUDA devices of ``sync``: a tensor or a list or tuple of them."""
    tensors = [sync] if isinstance(sync, torch.Tensor) else sync or ()
    return {t.device for t in tensors if t.device.type == "cuda"}


@dataclass
class Profiler:
    """Push per-phase timings; ``report()`` prints at most once per
    ``interval`` seconds (the reference prints once per second,
    `Program.cpp:358-373`)."""

    interval: float = 1.0
    items: list[ProfileItem] = field(default_factory=list)
    _last_report: float = 0.0

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase, recorded as span ``name`` too; pass tensors via
        ``sync`` to wait for the card's work on them (the analog of the
        reference's ``cudaDeviceSynchronize()`` "DEBUG" sync points,
        `Program.cpp:297,332`), a ``sync.phase`` span."""
        item = ProfileItem(name, start=time.perf_counter())
        with span(name):
            try:
                yield item
            finally:
                devices = _cuda_devices(sync)
                if devices:
                    with host_sync("sync.phase"):
                        for dev in devices:
                            torch.cuda.synchronize(dev)
                item.end = time.perf_counter()
                self.items.append(item)

    def push(self, item: ProfileItem) -> None:
        item.end = time.perf_counter()
        self.items.append(item)

    def report(self, force: bool = False) -> str | None:
        now = time.perf_counter()
        if not force and now - self._last_report < self.interval:
            self.items.clear()
            return None
        self._last_report = now
        lines = ["--- Profile Items ---"]
        for item in self.items:
            lines.append(f"{item.name}\t{item.elapsed_ms:.3f}")
        self.items.clear()
        out = "\n".join(lines)
        print(out)
        return out


#: The Chrome trace thread id of the program's span track.
_SPAN_TRACK = 0


def _span_events(record: Record, base_ns: int = 0, pid: int = 0) -> list:
    """Chrome trace events of the record: its spans (``"ph": "X"``,
    microseconds after ``base_ns``) on one track named ``program``, and
    each counter's total (``"ph": "C"``) at the last span's end."""
    events = [{"ph": "M", "name": "thread_name", "pid": pid,
               "tid": _SPAN_TRACK, "args": {"name": "program"}}]
    for s in record.spans:
        events.append({"ph": "X", "cat": "program", "name": s.name,
                       "pid": pid, "tid": _SPAN_TRACK,
                       "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent,
                                "unit": s.unit}})
    end = max((s.end_ns for s in record.spans), default=base_ns)
    for name, total in sorted(record.counters.items()):
        events.append({"ph": "C", "cat": "program", "name": name,
                       "pid": pid, "ts": (end - base_ns) / 1e3,
                       "args": {name: total}})
    return events


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a `torch.profiler` trace of the block (CPU, and CUDA when
    there is a card) with program tracing on, into
    ``log_dir/trace.json``, a Chrome trace in which the program's spans
    lie on a ``program`` track of the profiler's time base — the
    machine-readable successor to the reference's Nsight `aa.xml`.  The
    spans and counters recorded until then are taken (`collect`)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with tracing():
        with profile(activities=activities) as prof:
            yield prof
        record = collect()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(_span_events(
        record, int(trace.get("baseTimeNanoseconds", 0)), os.getpid()))
    with open(path, "w") as f:
        json.dump(trace, f)
