"""Kernel C's share of its roofline in an Adam step's forward render, in
percent (`portbench/roofline.py`)."""

from portbench import roofline


def install(tracer):
    roofline.install(tracer)


def read(trace):
    return roofline.share(trace, "_primary_cuda")
