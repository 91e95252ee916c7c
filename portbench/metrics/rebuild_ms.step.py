"""Ms an Adam step spends rebuilding the cluster set from the current
positions (`accel/clusters.build_clusters`): the harness's span of CUDA
events around the call."""

import statistics


def read(trace):
    spans = trace.spans.get("rebuild")
    return statistics.mean(spans) if spans else None
