"""(Tile, cluster) pairs a bounce frame that the general cull listed for
kernel F: the program's ``general_pairs`` counter
(`trace/bounce_sweep.py`, `portbench/program.py`).  None where the
program keeps no such counter."""

from portbench import program


def install(tracer):
    program.install(tracer)


def read(trace):
    rec = program.record(trace)
    if rec is None or "general_pairs" not in rec.counters:
        return None
    return rec.counters["general_pairs"] / trace.units
