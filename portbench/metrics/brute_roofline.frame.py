"""Kernel E's share of its roofline in a brute-force frame, in percent:
every ray against every face at the FP32 peak
(`portbench/brute_roofline.py`)."""

from portbench import brute_roofline


def install(tracer):
    brute_roofline.install(tracer)


def read(trace):
    return brute_roofline.share(trace)
