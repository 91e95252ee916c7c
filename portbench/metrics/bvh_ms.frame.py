"""Device ms a frame of the LBVH kernels of `csrc/bvh.cu`: kernel L
(`beam_walk_kernel`, `beam_test_kernel`, `beam_epilogue_kernel`) and
kernel K (`walk_kernel`, closest or any hit), by kernel name."""

from portbench.tracing import kernel_ms

KERNELS = ("beam_walk_kernel", "beam_test_kernel", "beam_epilogue_kernel",
           "walk_kernel")


def read(trace):
    ms = kernel_ms(trace, KERNELS)
    return ms / trace.units if ms else None
