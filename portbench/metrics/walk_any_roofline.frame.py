"""Kernel K's (any hit) share of its bytes bound in a frame, in percent
(`portbench/lbvh_roofline.py`)."""

from portbench import lbvh_roofline


def install(tracer):
    lbvh_roofline.install(tracer)


def read(trace):
    return lbvh_roofline.share(trace, "_walk_any_cuda")
