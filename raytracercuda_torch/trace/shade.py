"""Texture sampling (counterpart of `raytracercuda_tpu/trace/shade.py:60-84`).
The other shading functions come with the public-API slice of the port."""

from __future__ import annotations

import torch


def sample_texture(textures: torch.Tensor, tex_id: torch.Tensor,
                   u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch from the ``[T,H,W,3]`` atlas with wrap addressing."""
    t, h, w = textures.shape[0], textures.shape[1], textures.shape[2]
    # torch.remainder, like jnp's %, takes the sign of the divisor.
    fu = torch.remainder(u, 1.0) * (w - 1)
    fv = torch.remainder(v, 1.0) * (h - 1)
    x0 = torch.floor(fu).to(torch.int64)
    y0 = torch.floor(fv).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    ax = (fu - x0)[..., None]
    ay = (fv - y0)[..., None]
    tid = torch.clamp(tex_id.to(torch.int64), 0, t - 1)
    c00 = textures[tid, y0, x0]
    c01 = textures[tid, y0, x1]
    c10 = textures[tid, y1, x0]
    c11 = textures[tid, y1, x1]
    top = c00 * (1 - ax) + c01 * ax
    bot = c10 * (1 - ax) + c11 * ax
    return top * (1 - ay) + bot * ay
