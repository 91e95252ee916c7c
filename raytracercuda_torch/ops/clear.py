"""Framebuffer clear, kernel D (counterpart of
`raytracercuda_tpu/ops/clear.py`).

Fills a packed ``torch.uint32`` framebuffer (`ops/math.py`) with one u32
value: 0xFF00FF00 reads back as 0xFF00FF00.  `clear_buffer` runs its plain
PyTorch version (`torch.full`) for the CPU and launches kernel D
(`csrc/frame.cu:clear_kernel`, replacing `clear._clear_kernel`) on a GPU;
there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .cuda_build import kernel_fn, raw_stream

#: Kernel launches, counted where the kernel is launched.
launch_counts = {"clear": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _clear_plain(num_pixels: int, value: int, device) -> torch.Tensor:
    return torch.full((num_pixels,), value, dtype=torch.uint32, device=device)


def _clear_cuda(num_pixels: int, value: int, device) -> torch.Tensor:
    """Launch kernel D; output as in `_clear_plain`."""
    if device.type != "cuda":
        raise ValueError(f"kernel D writes a CUDA tensor, not one on {device}")
    out = torch.empty(num_pixels, dtype=torch.uint32, device=device)
    err = kernel_fn("rt_clear")(out.data_ptr(), num_pixels, value,
                                raw_stream(device))
    if err:
        raise RuntimeError(f"kernel D launch failed: CUDA error {err}")
    launch_counts["clear"] += 1
    return out


def clear_buffer(num_pixels: int, value: int,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """A ``[num_pixels]`` uint32 framebuffer of the u32 ``value`` on
    ``device`` (the card when None)."""
    device = resolve_device(device)
    value = int(value) & 0xFFFFFFFF  # the JAX package's uint32 cast
    run = _clear_plain if device.type == "cpu" else _clear_cuda
    return run(int(num_pixels), value, device)
