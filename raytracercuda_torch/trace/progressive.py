"""Progressive accumulation rendering (counterpart of
`raytracercuda_tpu/trace/progressive.py:29-119`).

Successive frames sample jittered sub-pixel ray grids and accumulate a
running mean.  The jitter comes from the Halton (2, 3) sequence, so there
is no random state and an accumulation repeats bit for bit.  A step
composes `diff.render_grad.render_rgb`, so gradients flow through it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..device import resolve_device
from ..diff.render_grad import render_rgb
from ..utils.profiler import span


def halton(index: int, base: int) -> np.float32:
    """Halton radical inverse of ``index`` in ``base``, in float32, bit for
    bit as XLA compiles the JAX package's loop: ``f / base`` becomes a
    multiply by the float32 reciprocal, and ``r + f * digit`` one fused
    multiply-add (exact here in float64, where the product of a float32
    and a small integer is exact)."""
    step = np.float32(1.0 / base)
    f = np.float32(1.0)
    r = np.float32(0.0)
    i = int(index)
    while i > 0:
        f = np.float32(f * step)
        r = np.float32(np.float64(r) + np.float64(f) * (i % base))
        i //= base
    return r


def jittered_ray_grid(
    width: int,
    height: int,
    jitter_x: float,
    jitter_y: float,
    left: float = -1.0,
    right: float = 1.0,
    top: float = 1.0,
    bottom: float = -1.0,
    zoom: float = 1.0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Pinhole grid ``[H*W, 3]`` sampled at sub-pixel offset (jx, jy) in
    [0, 1) instead of the pixel centres (`camera_ray_grid`), on ``device``
    (the card when None)."""
    device = resolve_device(device)
    dx = (right - left) / width
    dy = (bottom - top) / height
    # The offsets enter as Python scalars, which the sums round to float32
    # as a float32 tensor would be: a copy from host memory would wait for
    # the device's queue.
    jx, jy = float(jitter_x), float(jitter_y)
    rx = left + dx * (torch.arange(width, dtype=torch.float32, device=device)
                      + jx)
    ry = top + dy * (torch.arange(height, dtype=torch.float32, device=device)
                     + jy)
    gx = rx[None, :].expand(height, width)
    gy = ry[:, None].expand(height, width)
    d = 1.0 / torch.sqrt(zoom * zoom + gx * gx + gy * gy)
    gz = torch.full_like(gx, zoom)
    return torch.stack([gx * d, gy * d, gz * d], dim=-1).reshape(
        height * width, 3)


class ProgressiveState(NamedTuple):
    accum: torch.Tensor  # [R, 3] running sum of samples
    count: int  # samples so far (host side: it picks the next jitter)

    @property
    def image(self) -> torch.Tensor:
        return self.accum / float(max(self.count, 1))


def init_progressive(num_rays: int, device: torch.device | str | None = None
                     ) -> ProgressiveState:
    """An empty accumulation on ``device`` (the card when None)."""
    return ProgressiveState(
        accum=torch.zeros((num_rays, 3), dtype=torch.float32,
                          device=resolve_device(device)),
        count=0)


def progressive_step(
    state: ProgressiveState,
    scene,
    accel,
    eye: torch.Tensor,
    orient: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
    shading: str = "lambert",
    with_shadows: bool = False,
    zoom: float = 1.0,
) -> ProgressiveState:
    """Accumulate one jittered sample frame into the running sum (span
    ``pass``)."""
    with span("pass"):
        jx = halton(state.count + 1, 2)
        jy = halton(state.count + 1, 3)
        rays = jittered_ray_grid(width, height, jx, jy, zoom=zoom,
                                 device=state.accum.device)
        # A jittered pinhole grid still shares one origin per tile, so the
        # frame takes kernel C's tile route.
        rgb = render_rgb(scene, accel, rays, eye, orient, config,
                         shading=shading, with_shadows=with_shadows,
                         frame_hw=(height, width))
        return ProgressiveState(accum=state.accum + rgb,
                                count=state.count + 1)
