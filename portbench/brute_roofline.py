"""Kernel E, the brute-force closest hit (`trace/bruteforce.py`'s
`_brute_cuda`, the route of `AccelKind.BRUTE`): its device time a launch
and its share of its roofline, the least time its work needs
(`yardstick`) over that time.

E's one C entry launches `fill_keys_kernel`, `brute_items_kernel<P>`
(left out where the scene has no face) and `brute_epilogue_kernel`, in
that order on one stream.  Its fill shares its name with those of A, C
and F, so a fill is E's only where it is the activity that starts last
before E's items or, without them, before E's epilogue
(`bounce_roofline.entry_launches_us`).

The tests are every ray against every face, counted from the inputs the
wrapper hands the kernel: its rays times the faces of its ``[9, F]``
columns, `yardstick.MT_OPS` operations each; the bytes are those of its
inputs and outputs, each once."""

from __future__ import annotations

import torch

from .bounce_roofline import entry_launches_us, entry_share
from .yardstick import nbytes

ITEMS = "brute_items_kernel"
EPILOGUE = "brute_epilogue_kernel"
WRAPPER = "_brute_cuda"


def launches_us(trace) -> list:
    """Device us of each of E's launches recorded in the slice."""
    return entry_launches_us(trace, ITEMS, EPILOGUE)


def install(tracer) -> None:
    """Count each call's tests and bytes while the traced slice runs."""
    from raytracercuda_torch.trace import bruteforce

    launch = getattr(bruteforce, WRAPPER)

    def counted(*args):
        out = launch(*args)
        direction, tris = args[1], args[2]
        tracer.count(WRAPPER, torch.tensor(direction.shape[0] * tris.shape[1],
                                           dtype=torch.int64),
                     nbytes(*args, out))
        return out

    tracer.patch(bruteforce, WRAPPER, counted)


def share(trace):
    """Percent of the bound that E reaches over the slice
    (`bounce_roofline.entry_share`)."""
    return entry_share(trace, WRAPPER, launches_us(trace))
