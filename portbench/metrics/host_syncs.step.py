"""Host syncs an Adam step: the program's ``host_syncs`` counter, one at
each call that waits for the device (`portbench/program.py`)."""

from portbench import program


def install(tracer):
    program.install(tracer)


def read(trace):
    return program.host_syncs(trace)
