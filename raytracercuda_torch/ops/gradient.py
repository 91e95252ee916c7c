"""Six-band colour gradient, kernel I (counterpart of
`raytracercuda_tpu/ops/gradient.py`).

The reference's simplest full-frame display test (`Gradient.cu:5-52`): the
linear pixel index picks one of six colour ramps (R, G, B, RG, GB, RB),
each fading 0..255 across its band.  `color_gradient` runs its plain
PyTorch version for the CPU and launches kernel I (`csrc/frame.cu:
gradient_kernel`, replacing `gradient.color_gradient`'s inline kernel) on
a GPU; there is no fallback from one to the other.  The kernel works
band-major: each ramp position ``k`` of ``[0, size // 6)`` gets its colour
once and is stored into the six bands at ``b * (size // 6) + k``, which
gives `gradient_values`' pixels, since every value of ``i % block`` recurs
once a band.  Packed pixels are uint32, as in `ops/math.py`.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .cuda_build import kernel_fn, raw_stream
from .math import as_u32

#: Kernel launches, counted where the kernel is launched.
launch_counts = {"gradient": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def gradient_values(i: torch.Tensor, size: int) -> torch.Tensor:
    """Packed pixels (uint32) for linear indices ``i`` (`Gradient.cu:8-40`):
    ``i`` clamped to 0 from ``size`` on, ``block = size // 6``, ``c =
    trunc(float32(i % block) / float32(block) * 255)`` (an IEEE division,
    then a multiply: the CUDA kernel's two roundings), and zero past band 5
    when ``size % 6 != 0``."""
    i = torch.where(i < size, i, 0)
    block = size // 6
    band = i // block
    x = (i % block).to(torch.float32)
    # A divisor tensor, not a scalar: on the card torch turns division by a
    # scalar into a multiply by its reciprocal, which rounds otherwise.
    c = (x / torch.full_like(x, float(block)) * 255.0).to(torch.int32)
    bands = [c << 16, c << 8, c, (c << 16) | (c << 8), (c << 8) | c,
             (c << 16) | c]
    out = torch.zeros_like(c)
    for k, value in enumerate(bands):
        out = torch.where(band == k, value, out)
    return as_u32(out)


def _gradient_plain(size: int, device) -> torch.Tensor:
    return gradient_values(torch.arange(size, device=device), size)


def _gradient_cuda(size: int, device) -> torch.Tensor:
    """Launch kernel I; output as in `_gradient_plain`."""
    if device.type != "cuda":
        raise ValueError(f"kernel I writes a CUDA tensor, not one on {device}")
    out = torch.empty(size, dtype=torch.uint32, device=device)
    err = kernel_fn("rt_gradient")(out.data_ptr(), size, raw_stream(device))
    if err:
        raise RuntimeError(f"kernel I launch failed: CUDA error {err}")
    launch_counts["gradient"] += 1
    return out


def color_gradient(width: int, height: int,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """``bmStartColorGradient``: the ``[width*height]`` uint32 frame on
    ``device`` (the card when None).  Raises `ValueError` below 6 pixels,
    where the band width ``size // 6`` is 0 (the JAX and CUDA integer
    divisions by it are undefined)."""
    size = int(width) * int(height)
    if size < 6:
        raise ValueError(f"color_gradient needs at least 6 pixels, got "
                         f"{width}x{height} = {size}")
    device = resolve_device(device)
    run = _gradient_plain if device.type == "cpu" else _gradient_cuda
    return run(size, device)
