"""Device-idle ms a frame (a progressive pass) inside the program's root
spans: the device waiting on the program's host code
(`portbench/program.py`)."""

from portbench import program


def install(tracer):
    program.install(tracer)


def read(trace):
    return program.glue_idle_ms(trace)
