"""Device ms an Adam step of kernel G, the backward scatter of
`csrc/scatter.cu` (its fill, scatter and sorted-route kernels)."""

from portbench.tracing import kernel_ms

KERNELS = ("zero_rows_kernel", "scatter_add_kernel", "segment_sum_kernel")


def read(trace):
    ms = kernel_ms(trace, KERNELS)
    return ms / trace.units if ms else None
