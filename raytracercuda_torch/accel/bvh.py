"""Morton codes (counterpart of `raytracercuda_tpu/accel/bvh.py:112-136`).

The LBVH itself comes with a later slice of the port.  Codes are int64
where the JAX package uses uint32; the 30-bit values are the same.
"""

from __future__ import annotations

import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x two apart (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(q: torch.Tensor) -> torch.Tensor:
    """``[...,3]`` int64 (10-bit) -> 30-bit Morton codes."""
    return ((_part1by2(q[..., 0]) << 2) | (_part1by2(q[..., 1]) << 1)
            | _part1by2(q[..., 2]))


def morton_codes(centroids: torch.Tensor, smin: torch.Tensor,
                 smax: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Quantize centroids into the scene AABB and interleave: the same
    ``((c - smin) / extent) * scale``, clip, truncate as the JAX package."""
    scale = (1 << bits) - 1
    extent = torch.clamp(smax - smin, min=1e-12)
    q = torch.clamp((centroids - smin) / extent * scale, 0, scale)
    return morton3d(q.to(torch.int64))
