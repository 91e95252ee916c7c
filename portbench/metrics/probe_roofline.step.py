"""The probes' sweep (C's epilogue over F's sweep) as a share of its
roofline in a silhouette step, in percent, on the active rays' tests
(`portbench/probe_roofline.py`)."""

from portbench import probe_roofline


def install(tracer):
    probe_roofline.install(tracer)


def read(trace):
    return probe_roofline.share(trace)
