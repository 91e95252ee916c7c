"""Wall-clock timers — ``Util::time/timeD`` analog (`Raytracer/Util.cpp:9-28`):
run-relative seconds since first call, absolute seconds, float and double
variants collapsed into one (a copy of `raytracercuda_tpu/utils/timer.py`)."""

from __future__ import annotations

import time as _time

_t0: float | None = None


def abs_time() -> float:
    """Absolute seconds (chrono steady-clock analog)."""
    return _time.perf_counter()


def run_time() -> float:
    """Seconds since the first call in this process (`Util.cpp:14-21`)."""
    global _t0
    now = _time.perf_counter()
    if _t0 is None:
        _t0 = now
    return now - _t0


# Reference exposes float and double variants; one suffices in Python.
time = run_time
timeD = run_time
