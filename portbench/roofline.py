"""The roofline share of the closest-hit sweeps, kernels A (frames) and C
(the differentiable render): the least time their work needs (`yardstick`)
over the device time the profiler gives their kernels.

The tests are counted from the inputs that the program's launch wrappers
(`trace/sweep.py`: `_primary_shade_cuda`, A; `_primary_cuda`, C) pass to
the kernel: every listed cluster's triangles for each ray of its tile,
which is the work both kernels do.  A later change that lets A or C skip
listed work leaves this count stale; the benchmark then recounts it."""

from __future__ import annotations

import torch

from .yardstick import MT_OPS, bound, nbytes, sweep_tests

#: Each wrapper's kernels as the profiler names them, and the dimension of
#: its direction tiles that holds a tile's rays.
KERNELS = {
    "_primary_shade_cuda": (("fill_keys_kernel",
                             "sweep_items_kernel<false, true>",
                             "shade_epilogue_kernel<false>"), 2),
    "_primary_cuda": (("fill_keys_kernel", "sweep_items_kernel<false, false>",
                       "closest_epilogue_kernel<false, false>"), 1),
}


def install(tracer) -> None:
    """Count each call's tests and bytes while the traced slice runs."""
    from raytracercuda_torch.trace import sweep

    for wrapper, (_, ray_dim) in KERNELS.items():
        launch = getattr(sweep, wrapper)

        def counted(*args, _launch=launch, _wrapper=wrapper, _dim=ray_dim):
            out = _launch(*args)
            lists, dirs, rows = args[0], args[2], args[3]
            tracer.count(_wrapper, sweep_tests(lists.counts, dirs.shape[_dim],
                                               rows.shape[1]),
                         nbytes(*args, out))
            return out

        tracer.patch(sweep, wrapper, counted)


def share(trace, wrapper: str):
    """Percent of the bound that ``wrapper``'s kernels reach over the
    slice, or None where it made no call or a kernel went unrecorded.
    A kernel's time is its mean recorded duration times the calls, so
    that launches the profiler drops do not read as speed."""
    calls = trace.calls.get(wrapper)
    if not calls:
        return None
    kernel_ms = 0.0
    for name in KERNELS[wrapper][0]:
        durs = [d for n, _, d in trace.activities if n == name]
        if not durs:
            return None
        kernel_ms += sum(durs) / len(durs) * len(calls) / 1e3
    tests = torch.stack([c.tests for c in calls]).cpu().tolist()
    bound_ms = sum(bound(t * MT_OPS, c.nbytes) for t, c in zip(tests, calls))
    return 100.0 * bound_ms / kernel_ms
