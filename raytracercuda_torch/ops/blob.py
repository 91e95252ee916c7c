"""Animated rounded-square SDF "blob", kernel J (counterpart of
`raytracercuda_tpu/ops/blob.py`).

The reference's procedural-animation test (`Blob.cu:5-69`): a rotating
rounded-square signed distance field, smoothstep-mixed with red over a
vignetted white background.  The time is a runtime value: kernel J
(`csrc/frame.cu:blob_kernel`, replacing `blob.blob`'s inline kernel) takes
a float time by value, or reads a one-element float32 tensor on the card
in place, so a new time neither rebuilds, copies nor syncs the host; both
forms are ``float32(time)``.  The kernel computes each pixel from its row
and column, four pixels a thread.  Packed pixels are uint32, as in
`ops/math.py`.  `blob` runs the plain PyTorch version for
the CPU and launches kernel J on a GPU; there is no fallback from one to
the other.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .cuda_build import kernel_fn, raw_stream
from .math import pack_rgb

#: Kernel launches, counted where the kernel is launched.
launch_counts = {"blob": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _square_sdf(ux, uy, hx, hy):
    """`Blob.cu:5-11`: rounded-square distance."""
    dx = torch.abs(ux) - hx
    dy = torch.abs(uy) - hy
    t = torch.clamp(torch.maximum(dx, dy), max=0.0)
    lx = torch.clamp(dx, min=0.0)
    ly = torch.clamp(dy, min=0.0)
    return t + torch.sqrt(lx * lx + ly * ly)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def blob_values(i: torch.Tensor, w: int, h: int,
                time: torch.Tensor) -> torch.Tensor:
    """Packed pixels (uint32) for linear indices ``i`` at ``time`` (a
    float32 tensor of one element) (`Blob.cu:27-58`)."""
    size = w * h
    i = torch.clamp(i, max=size)
    ux = (i % w).to(torch.float32) - (w // 2)
    uy = (i // w).to(torch.float32) - (h // 2)
    s, c = torch.sin(time), torch.cos(time)
    rx = c * ux - s * uy
    ry = s * ux + c * uy
    ry = ry * 2.0
    d = _square_sdf(rx, ry, 100.0, 100.0)
    f = 1.0 - _smoothstep(-1.0, 1.0, d)
    # A divisor tensor, not a scalar: on the card torch turns division by a
    # scalar into a multiply by its reciprocal, which rounds otherwise.
    shade = 1.0 - torch.clamp(d / torch.full_like(d, 1500.0), 0.0, 1.0)
    bg = shade * shade  # pow(s, 2) * white background
    # mix(bg, red, f) componentwise: red = (1, 0, 0).
    mr = bg * (1.0 - f) + 1.0 * f
    mg = bg * (1.0 - f)
    mb = bg * (1.0 - f)
    return pack_rgb(mr, mg, mb)


def _blob_plain(width: int, height: int, time, device) -> torch.Tensor:
    if not isinstance(time, torch.Tensor):
        time = torch.tensor([time], dtype=torch.float32, device=device)
    return blob_values(torch.arange(width * height, device=device),
                       width, height, time)


def _blob_cuda(width: int, height: int, time, device) -> torch.Tensor:
    """Launch kernel J at ``time``, a float (passed by value) or a float32
    tensor of one element on the card (read in place; the frame is made on
    its device); output as in `_blob_plain`."""
    if device.type != "cuda":
        raise ValueError(f"kernel J writes a CUDA tensor, not one on {device}")
    if isinstance(time, torch.Tensor):
        if not time.is_cuda or time.dtype != torch.float32 \
                or time.numel() != 1:
            raise ValueError(f"kernel J reads a CUDA float32 time of one "
                             f"element, got {time.dtype} "
                             f"{tuple(time.shape)} on {time.device}")
        ptr, value, device = time.data_ptr(), 0.0, time.device
    else:
        ptr, value = None, time
    out = torch.empty(width * height, dtype=torch.uint32, device=device)
    err = kernel_fn("rt_blob")(out.data_ptr(), width, height, ptr, value,
                               raw_stream(device))
    if err:
        raise RuntimeError(f"kernel J launch failed: CUDA error {err}")
    launch_counts["blob"] += 1
    return out


def blob(width: int, height: int, time,
         device: torch.device | str | None = None) -> torch.Tensor:
    """``bmStartBlob``: the ``[width*height]`` uint32 frame at ``time`` on
    ``device`` (the card when None).  ``time`` is a float, passed to the
    kernel by value as float32, or a tensor of one element, used in place
    when it is float32 on the device already."""
    device = resolve_device(device)
    if isinstance(time, torch.Tensor):
        time = time.to(device=device, dtype=torch.float32).reshape(1)
    else:
        time = float(time)
    run = _blob_plain if device.type == "cpu" else _blob_cuda
    return run(int(width), int(height), time, device)
