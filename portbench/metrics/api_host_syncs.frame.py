"""Host syncs a public-API frame: the program's ``host_syncs`` counter,
one at each call that waits for the device, such as ``Scene.march``'s
copies of a host eye and orientation (`portbench/program.py`).  None
where the program records no ``frame`` root."""

from portbench import program


def install(tracer):
    program.install(tracer)


def read(trace):
    rec = program.record(trace)
    if rec is None or not any(s.parent is None and s.name == "frame"
                              for s in rec.spans):
        return None
    return program.host_syncs(trace)
