"""Device ms a frame of the tile sweeps of `csrc/sweep.cu` (A and B in a
frame; C and H in a progressive pass), by kernel name."""

from portbench.tracing import kernel_ms

KERNELS = ("fill_keys_kernel", "sweep_items_kernel", "shade_epilogue_kernel",
           "closest_epilogue_kernel", "clear_flags_kernel",
           "occlusion_items_kernel")


def read(trace):
    ms = kernel_ms(trace, KERNELS)
    return ms / trace.units if ms else None
