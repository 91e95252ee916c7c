"""Device ms a silhouette step of the boundary term's probes: each sweep
call's `fill_keys_kernel`, `sweep_items_kernel<true, true>` and
`closest_epilogue_kernel<true, true>` by launch order and name, and the
`general_cull_kernel` launches (`portbench/probe_roofline.py`)."""

from portbench import probe_roofline


def read(trace):
    return probe_roofline.probe_ms(trace)
