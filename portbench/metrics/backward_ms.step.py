"""Ms an Adam step spends in ``loss.backward()``: the harness's span of
CUDA events around the call (the diff glue's recompute, autograd and
kernel G)."""

import statistics


def read(trace):
    spans = trace.spans.get("backward")
    return statistics.mean(spans) if spans else None
