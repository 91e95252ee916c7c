"""Device ms a frame of kernel F, the mirror bounces' closest hit and
attributes: its `sweep_items_kernel<true, true>` and
`shade_epilogue_kernel<true>` by name, and the `fill_keys_kernel` of each
of its launches by launch order (`portbench/bounce_roofline.py`)."""

from portbench import bounce_roofline


def read(trace):
    us = sum(bounce_roofline.launches_us(trace))
    return us / 1e3 / trace.units if us else None
