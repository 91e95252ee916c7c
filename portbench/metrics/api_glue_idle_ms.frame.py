"""Device-idle ms a public-API frame inside the program's root spans:
``api.clear`` (`Camera.clear`) and ``frame`` (`Scene.march`) less the
device's activity within them, the device waiting on the API's host code
(`portbench/program.py`).  None where the program records no ``frame``
root."""

from portbench import program


def install(tracer):
    program.install(tracer)


def read(trace):
    rec = program.record(trace)
    if rec is None or not any(s.parent is None and s.name == "frame"
                              for s in rec.spans):
        return None
    return program.glue_idle_ms(trace)
