"""The share of the traced window in which no operation ran on the
device, in percent: 1 - (union of device activity) / window."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
