"""The probes of the silhouette term (`diff/edge_grad.py:boundary_vjp`):
rays from the eye just inside and outside each live edge sample, traced
as a bundle by `trace/bounce_sweep.py:trace_rays`.  Their device time a
step and their sweep's share of its roofline, the least time its work
needs (`yardstick`) over that time.

`trace_rays` runs the general cull (`general_cull_kernel`, one launch a
call) and then C's epilogue over F's sweep through the name
`bounce_sweep._closest_rays_cuda`: one C entry that launches
`fill_keys_kernel`, `sweep_items_kernel<true, true>` (left out where no
tile lists a cluster) and `closest_epilogue_kernel<true, true>`, in that
order on one stream.  The fill's name is shared with A's, C's, E's and
F's, and the sweep's with F's, so each launch's fill and sweep are
attributed by that order (`bounce_roofline.entry_launches_us`), never by
the name's mean over the slice.

The tests are counted from the inputs the wrapper hands the kernel:
every listed cluster's triangles for each active ray of its tile
(`yardstick.sweep_tests` with ``active``); the bytes are those of its
inputs and outputs, each once."""

from __future__ import annotations

from .bounce_roofline import entry_launches_us, entry_share
from .tracing import kernel_ms
from .yardstick import nbytes, sweep_tests

SWEEP = "sweep_items_kernel<true, true>"
EPILOGUE = "closest_epilogue_kernel<true, true>"
CULL = "general_cull_kernel"
WRAPPER = "_closest_rays_cuda"


def launches_us(trace) -> list:
    """Device us of each of the probes' sweep calls recorded in the
    slice: its epilogue, and the sweep and the fill just before it."""
    return entry_launches_us(trace, SWEEP, EPILOGUE)


def probe_ms(trace):
    """Device ms a unit of the probes: their sweeps (`launches_us`) and
    the general culls; None where the slice recorded neither."""
    ms = sum(launches_us(trace)) / 1e3 + kernel_ms(trace, (CULL,))
    return ms / trace.units if ms else None


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
    """Percent of the bound that the probes' sweep reaches over the slice
    (`bounce_roofline.entry_share`)."""
    return entry_share(trace, WRAPPER, launches_us(trace))
