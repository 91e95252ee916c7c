"""Device ms a frame of kernel E, the brute-force closest hit: its
`brute_items_kernel` and `brute_epilogue_kernel` by name, and the
`fill_keys_kernel` of each of its launches by launch order
(`portbench/brute_roofline.py`)."""

from portbench import brute_roofline


def read(trace):
    us = sum(brute_roofline.launches_us(trace))
    return us / 1e3 / trace.units if us else None
