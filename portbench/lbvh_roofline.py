"""The roofline shares of the LBVH kernels: L (`trace/beam.py`'s
`_beam_cuda`, the tile beam of a frame's primary rays) and K's any hit
(`trace/traverse.py`'s `_walk_any_cuda`, the shadow rays).  Each is the
least time its bytes need (`yardstick.bound` with no operations) over the
device time the profiler gives its kernels.

The bytes are those of the tensors each wrapper hands its kernel or
returns, each counted once: the structure's packed nodes, links and
triangles (`Bvh.packed_nodes`, `packed_links`, `packed_tris`, not every
field of the tuple), then the eye, the directions and the tile planes
(L) or the origins, the directions and ``t_max`` (K), then the outputs.
That is what any implementation of the query on this structure must read
and write, so the kernels cannot take less time.  A walk is bound by the
latency of its dependent loads, one node after another along each ray or
tile, and not by bandwidth or arithmetic: these shares read low (about 1
to 5%).

A kernel's time is the sum of its recorded launches in the slice: L
launches its walk and test once a round, a number that depends on the
frame, so a mean a launch does not give its time a call.
"""

from __future__ import annotations

import torch

from .tracing import kernel_ms
from .yardstick import bound, nbytes

#: Each wrapper's kernels as the profiler names them.
KERNELS = {
    "_beam_cuda": ("beam_walk_kernel", "beam_test_kernel",
                   "beam_epilogue_kernel"),
    "_walk_any_cuda": ("walk_kernel<true>",),
}
#: A walk's ray-triangle tests depend on the data; the bound counts none.
_NO_TESTS = torch.zeros((), dtype=torch.int64)


def _structure(bvh) -> tuple:
    return bvh.packed_nodes, bvh.packed_links, bvh.packed_tris


def install(tracer) -> None:
    """Count each call's bytes while the traced slice runs."""
    from raytracercuda_torch.trace import beam, traverse

    launch_beam = beam._beam_cuda
    launch_walk = traverse._walk_any_cuda

    def beam_counted(bvh, eye, dirs, planes, *args, **kw):
        out = launch_beam(bvh, eye, dirs, planes, *args, **kw)
        tracer.count("_beam_cuda", _NO_TESTS,
                     nbytes(*_structure(bvh), eye, dirs, planes, out))
        return out

    def walk_counted(bvh, origin, direction, t_max, *args, **kw):
        out = launch_walk(bvh, origin, direction, t_max, *args, **kw)
        tracer.count("_walk_any_cuda", _NO_TESTS,
                     nbytes(*_structure(bvh), origin, direction, t_max, out))
        return out

    tracer.patch(beam, "_beam_cuda", beam_counted)
    tracer.patch(traverse, "_walk_any_cuda", walk_counted)


def share(trace, wrapper: str):
    """Percent of the bytes bound that ``wrapper``'s kernels reach over
    the slice, or None where it made no call or its kernels went
    unrecorded."""
    calls = trace.calls.get(wrapper)
    if not calls:
        return None
    ms = kernel_ms(trace, KERNELS[wrapper])
    if not ms:
        return None
    return 100.0 * sum(bound(0, c.nbytes) for c in calls) / ms
