"""(Group, cluster) pairs a silhouette step that the general cull listed
for the boundary term's probes: the program's ``general_pairs`` counter
(`trace/bounce_sweep.py:trace_rays`, `portbench/program.py`).  None
where the program keeps no such counter."""

from portbench import program


def install(tracer):
    program.install(tracer)


def read(trace):
    rec = program.record(trace)
    if rec is None or "general_pairs" not in rec.counters:
        return None
    return rec.counters["general_pairs"] / trace.units
