"""The program's own spans and counters over the traced slice, for the
per-layer readers that read them.

`raytracercuda_torch/utils/profiler.py` records spans at the program's
phase boundaries (roots: a frame, a progressive pass, a step's
``accel.build``, ``render`` and ``grad``) and counts its host syncs, on
`time.time_ns`, the epoch clock of the profiler's events.  A reader's
``install(tracer)`` calls `install`, which switches that tracing on for
the traced slice alone through `Tracer.patch` (`Tracer.stop` switches it
off again), so ``--trace 0`` runs and the untraced rest of a window run
with it off.  `record` collects the slice's spans once, for every reader
that asks.  The spans emit no profiler annotation, so they add no device
activity to the trace.

On a program without the facility `install` does nothing and every
function here returns None.
"""

from __future__ import annotations

from .tracing import _union

#: The facility's switch, a global of its module.
SWITCH = "enabled"

_last = None  # (the slice's TraceData, its record): one slice a process


def _facility():
    """The program's tracing module, or None where it has none."""
    try:
        from raytracercuda_torch.utils import profiler
    except ImportError:
        return None
    if not (hasattr(profiler, SWITCH) and hasattr(profiler, "collect")):
        return None
    return profiler


def install(tracer) -> None:
    """Program tracing on for the slice, from an empty record."""
    profiler = _facility()
    if profiler is not None:
        profiler.collect()
        tracer.patch(profiler, SWITCH, True)


def record(trace):
    """The program's record (spans and counters) of the slice ``trace``
    reduces, or None where the program recorded no span."""
    global _last
    if _last is None or _last[0] is not trace:
        profiler = _facility()
        _last = (trace, profiler.collect() if profiler is not None else None)
    rec = _last[1]
    return rec if rec is not None and rec.spans else None


def host_syncs(trace):
    """Host syncs a unit: the ``host_syncs`` counter over the units."""
    rec = record(trace)
    if rec is None:
        return None
    return rec.counters.get("host_syncs", 0) / trace.units


def sync_wait_ms(trace):
    """Host ms a unit inside the ``sync.*`` spans: the host waiting for
    the device."""
    rec = record(trace)
    if rec is None:
        return None
    ns = sum(s.end_ns - s.start_ns for s in rec.spans
             if s.name.startswith("sync."))
    return ns / 1e6 / trace.units


def _busy_us(merged, lo: float, hi: float) -> float:
    """Microseconds of ``[lo, hi]`` that the merged, sorted device
    intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged
               if e > lo and s < hi)


def glue_idle_ms(trace):
    """Device-idle ms a unit inside the program's root spans: each root
    span less the union of the slice's device activities within it, on
    the shared clock.  The device waiting on the program's host code."""
    rec = record(trace)
    if rec is None:
        return None
    merged = _union((s, s + d) for _, s, d in trace.activities)
    idle_us = 0.0
    for s in rec.spans:
        if s.parent is None:
            lo, hi = s.start_ns / 1e3, s.end_ns / 1e3
            idle_us += (hi - lo) - _busy_us(merged, lo, hi)
    return idle_us / 1e3 / trace.units
