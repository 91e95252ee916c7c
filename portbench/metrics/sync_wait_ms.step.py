"""Host ms an Adam step inside the program's ``sync.*`` spans: the host
waiting for the device at its syncs (`portbench/program.py`)."""

from portbench import program


def install(tracer):
    program.install(tracer)


def read(trace):
    return program.sync_wait_ms(trace)
