"""Device activities (kernels, copies, fills) a frame over the traced
slice: the work the frame glue hands the device one launch at a time."""


def read(trace):
    return len(trace.activities) / trace.units if trace.activities else None
