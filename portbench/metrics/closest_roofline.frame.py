"""Kernel A's share of its roofline in a frame (kernel C's in a
progressive pass), in percent (`portbench/roofline.py`)."""

from portbench import roofline


def install(tracer):
    roofline.install(tracer)


def read(trace):
    a = roofline.share(trace, "_primary_shade_cuda")
    return a if a is not None else roofline.share(trace, "_primary_cuda")
