"""Kernel F, the closest hit and attributes of the mirror bounces
(`trace/sweep.py`'s `_general_shade_cuda`, called through
`trace/bounce_sweep.py`): its device time a launch and its share of its
roofline, the least time its work needs (`yardstick`) over that time.

F's one C entry launches `fill_keys_kernel`, `sweep_items_kernel<true,
true>` (left out where no tile lists a cluster) and
`shade_epilogue_kernel<true>`, in that order on one stream.  Its fill
shares its name with E's and with the overload that A and C launch, so a
fill is F's only where it is the activity that starts last before F's
sweep or, without one, before F's epilogue: each launch's fill is
attributed by that order, never by the name's mean over the slice.

The tests are counted from the inputs the wrapper hands the kernel:
every listed cluster's triangles for each active ray of its tile
(`yardstick.sweep_tests` with ``active``), the work F's pass 1 does; the
bytes are those of its inputs and outputs, each once."""

from __future__ import annotations

import torch

from .yardstick import MT_OPS, bound, nbytes, sweep_tests

FILL = "fill_keys_kernel"
SWEEP = "sweep_items_kernel<true, true>"
EPILOGUE = "shade_epilogue_kernel<true>"
WRAPPER = "_general_shade_cuda"


def entry_launches_us(trace, middle: str, epilogue: str) -> list:
    """Device us of each launch recorded in the slice of a C entry that
    runs `FILL`, ``middle`` (left out where it has no work) and
    ``epilogue`` in that order on one stream: its epilogue, and the
    middle kernel and the fill just before it.  A name matches whole or
    up to its template arguments."""
    def named(name, want):
        return name == want or name.split("<")[0] == want

    acts = sorted(trace.activities, key=lambda a: a[1])
    out = []
    for i, (name, _, dur) in enumerate(acts):
        if not named(name, epilogue):
            continue
        j = i - 1
        if j >= 0 and named(acts[j][0], middle):
            dur += acts[j][2]
            j -= 1
        if j >= 0 and acts[j][0] == FILL:
            dur += acts[j][2]
        out.append(dur)
    return out


def entry_share(trace, wrapper: str, launches: list):
    """Percent of the bound of ``wrapper``'s calls over the slice that
    its ``launches`` (`entry_launches_us`) reach, or None where it made
    no call or none of its launches was recorded.  Its time is the mean
    recorded launch times the calls, so that launches the profiler drops
    do not read as speed."""
    calls = trace.calls.get(wrapper)
    if not calls or not launches:
        return None
    kernel_ms = sum(launches) / len(launches) * len(calls) / 1e3
    tests = torch.stack([c.tests for c in calls]).cpu().tolist()
    bound_ms = sum(bound(t * MT_OPS, c.nbytes) for t, c in zip(tests, calls))
    return 100.0 * bound_ms / kernel_ms


def launches_us(trace) -> list:
    """Device us of each of F's launches recorded in the slice."""
    return entry_launches_us(trace, SWEEP, EPILOGUE)


def install(tracer) -> None:
    """Count each call's tests and bytes while the traced slice runs."""
    from raytracercuda_torch.trace import bounce_sweep

    launch = getattr(bounce_sweep, WRAPPER)

    def counted(*args):
        out = launch(*args)
        lists, d3_tiles, active, blocks = args[0], args[2], args[3], args[4]
        tracer.count(WRAPPER, sweep_tests(lists.counts, d3_tiles.shape[2],
                                          blocks.shape[1], active),
                     nbytes(*args, out))
        return out

    tracer.patch(bounce_sweep, WRAPPER, counted)


def share(trace):
    """Percent of the bound that F reaches over the slice
    (`entry_share`)."""
    return entry_share(trace, WRAPPER, launches_us(trace))
