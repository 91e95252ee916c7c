"""Kernel F's share of its roofline in a frame with mirror bounces, in
percent (`portbench/bounce_roofline.py`)."""

from portbench import bounce_roofline


def install(tracer):
    bounce_roofline.install(tracer)


def read(trace):
    return bounce_roofline.share(trace)
