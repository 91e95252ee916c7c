"""Host ms a silhouette step inside the program's ``grad.boundary`` span:
the boundary term of `diff/edge_grad.py` (classify the edges, place the
samples, the live samples' sync, the probes' trace and shade, the
endpoints' pullback; `portbench/program.py`)."""

from portbench import program

SPAN = "grad.boundary"


def install(tracer):
    program.install(tracer)


def read(trace):
    rec = program.record(trace)
    if rec is None:
        return None
    ns = [s.end_ns - s.start_ns for s in rec.spans if s.name == SPAN]
    return sum(ns) / 1e6 / trace.units if ns else None
