"""The readers of the program's own spans and counters
(`portbench/program.py`) on a synthetic slice, and on a small frame of
the program on the CPU."""

from __future__ import annotations

import types

import pytest

from conftest import CPU, small_cell
from portbench import program, tracing
from portbench.kinds import KINDS

from raytracercuda_torch.utils import profiler
from raytracercuda_torch.utils.profiler import Record, Span

US = 1000  # ns a microsecond


def _slice(record, units=2, activities=()):
    """A `TraceData` of ``units`` units and the device ``activities``
    (name, start us, duration us), whose program record is ``record``."""
    trace = tracing.TraceData(units, 1.0, 0.5, list(activities), [], {}, {})
    fake = types.SimpleNamespace(enabled=False, collect=lambda: record)
    return trace, fake


def _read(name, trace):
    return tracing.load_reader(name).read(trace)


def _frames():
    """Two frames: roots 0-1000 us and 2000-2600 us, each with a sync span;
    the device busy 100-300, 250-400 (overlapping), 900-1100 and
    2100-2200 us."""
    spans = [
        Span(2, "sync.tile_lists", 150 * US, 350 * US, 1, 1),
        Span(3, "sweep.A", 400 * US, 500 * US, 1, 1),
        Span(1, "frame", 0, 1000 * US, None, 1),
        Span(5, "sync.light_basis", 2050 * US, 2100 * US, 4, 4),
        Span(4, "frame", 2000 * US, 2600 * US, None, 4),
    ]
    acts = [("a", 100.0, 200.0), ("b", 250.0, 150.0), ("c", 900.0, 200.0),
            ("d", 2100.0, 100.0)]
    return Record(spans, {"host_syncs": 6}), acts


@pytest.mark.parametrize("kind", ["frame", "step"])
def test_readers_on_a_synthetic_slice(monkeypatch, kind):
    record, acts = _frames()
    trace, fake = _slice(record, 2, acts)
    monkeypatch.setattr(program, "_facility", lambda: fake)
    monkeypatch.setattr(program, "_last", None)
    assert _read(f"host_syncs.{kind}", trace) == pytest.approx(3.0)
    assert _read(f"sync_wait_ms.{kind}", trace) == pytest.approx(
        (0.200 + 0.050) / 2)
    # Frame 1: 1000 us less 100-400 and 900-1000 busy; frame 2: 600 less
    # 100.
    assert _read(f"glue_idle_ms.{kind}", trace) == pytest.approx(
        ((1000 - 300 - 100) + (600 - 100)) / 1e3 / 2)


def test_the_record_is_collected_once_a_slice(monkeypatch):
    record, acts = _frames()
    calls = []
    trace, fake = _slice(record, 2, acts)

    def collect():
        calls.append(1)
        return record if len(calls) == 1 else None

    fake.collect = collect
    monkeypatch.setattr(program, "_facility", lambda: fake)
    monkeypatch.setattr(program, "_last", None)
    for name in ("host_syncs.frame", "sync_wait_ms.frame",
                 "glue_idle_ms.frame"):
        assert _read(name, trace) is not None
    assert len(calls) == 1
    other, _ = _slice(None, 2)
    assert _read("host_syncs.frame", other) is None  # a new slice, no span
    assert len(calls) == 2


def test_a_program_without_the_facility_reads_nothing(monkeypatch):
    monkeypatch.setattr(program, "_facility", lambda: None)
    monkeypatch.setattr(program, "_last", None)
    tracer = tracing.Tracer(CPU)
    program.install(tracer)
    assert tracer._patches == []
    trace, _ = _slice(None)
    for kind in ("frame", "step"):
        for name in ("host_syncs", "sync_wait_ms", "glue_idle_ms"):
            assert _read(f"{name}.{kind}", trace) is None


def test_install_switches_tracing_on_for_the_slice_alone(monkeypatch):
    """The slice's tracer turns the program's tracing on and gives it back
    off; a small near frame on the CPU then records its spans and the
    two host syncs of a frame (the primary and the shadow lists'
    `nonzero`)."""
    monkeypatch.setattr(program, "_last", None)
    cell = small_cell("bunny69k.c512.near")
    kind = KINDS["orbit"](cell.config, cell.traffic, 5, CPU)
    kind.unit(0, tracing.Tracer(CPU))
    assert profiler.collect().spans == []  # off outside a slice
    tracer = tracing.Tracer(CPU)
    try:
        program.install(tracer)
        assert profiler.enabled
        kind.unit(1, tracer)
        kind.unit(2, tracer)
    finally:
        for module, attr, value in reversed(tracer._patches):
            setattr(module, attr, value)
    assert not profiler.enabled
    trace = tracing.TraceData(2, 1.0, 0.0, [], [], {}, {})
    assert _read("host_syncs.frame", trace) == 2.0
    assert _read("sync_wait_ms.frame", trace) > 0.0
    roots = [s for s in program.record(trace).spans if s.parent is None]
    assert [s.name for s in roots] == ["frame", "frame"]
    # No device activity: the whole of each frame is idle.
    assert _read("glue_idle_ms.frame", trace) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in roots) / 1e6 / 2)
