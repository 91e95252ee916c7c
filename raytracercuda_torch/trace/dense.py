"""Pixel tiling and the tile-frustum cull (counterpart of
`raytracercuda_tpu/trace/dense.py:74-157`).

The TPU's matmul-form sweeps that share that module are not part of the
port: kernels A and B compute the same closest-hit and any-hit functions.
"""

from __future__ import annotations

import torch


def tile_pixels(x: torch.Tensor, height: int, width: int,
                tile_px: int) -> torch.Tensor:
    """``[H*W, ...]`` row-major -> ``[T, R, ...]`` tile-major."""
    trailing = tuple(x.shape[1:])
    th, tw = height // tile_px, width // tile_px
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(trailing)))
    return (x.reshape((th, tile_px, tw, tile_px) + trailing).permute(perm)
            .reshape((th * tw, tile_px * tile_px) + trailing))


def untile_pixels(x: torch.Tensor, height: int, width: int,
                  tile_px: int) -> torch.Tensor:
    """``[T, R, ...]`` tile-major -> ``[H*W, ...]`` row-major."""
    trailing = tuple(x.shape[2:])
    th, tw = height // tile_px, width // tile_px
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(trailing)))
    return (x.reshape((th, tw, tile_px, tile_px) + trailing).permute(perm)
            .reshape((height * width,) + trailing))


def tile_pixels_planar(x3: torch.Tensor, height: int, width: int,
                       tile_px: int) -> torch.Tensor:
    """Planar ``[3, H*W]`` row-major -> contiguous ``[T, 3, R]``
    tile-major."""
    th, tw = height // tile_px, width // tile_px
    return (x3.reshape(3, th, tile_px, tw, tile_px).permute(1, 3, 0, 2, 4)
            .reshape(th * tw, 3, tile_px * tile_px))


def tile_frustum_planes(d_tiles: torch.Tensor, tile_px: int) -> torch.Tensor:
    """Inward bounding planes ``[T, 5, 3]`` of each row-major ``[T, R, 3]``
    direction tile's pinhole beam: four corner planes and the mean
    direction (which rejects geometry behind the eye)."""
    r = tile_px * tile_px
    return frustum_planes(d_tiles[:, 0], d_tiles[:, tile_px - 1],
                          d_tiles[:, r - tile_px], d_tiles[:, r - 1],
                          d_tiles.mean(dim=1))


def frustum_planes(c00, c01, c10, c11, mean_dir) -> torch.Tensor:
    """``[T, 5, 3]`` planes from a tile's ``[T, 3]`` corner directions
    (top-left, top-right, bottom-left, bottom-right) and mean direction."""
    from ..ops.math import cross

    def plane(a, b):
        n = cross(a, b)
        s = torch.sign(torch.sum(n * mean_dir, dim=-1, keepdim=True))
        return n * torch.where(s == 0, 1.0, s)

    return torch.stack(
        [plane(c00, c01), plane(c01, c11), plane(c11, c10), plane(c10, c00),
         mean_dir], dim=1)


def _cull_frustum(planes: torch.Tensor, eye: torch.Tensor,
                  cmin: torch.Tensor, cmax: torch.Tensor) -> torch.Tensor:
    """``[T,5,3]`` planes x ``[C]`` cluster boxes -> ``[T,C]`` survive mask.

    p-vertex trick: the largest ``n.(corner - eye)`` over a box's corners
    is ``n.(mid - eye) + |n|.half``, so every plane tests every box in one
    ``[T*5, 6] @ [6, C]`` product; outside any plane => culled."""
    cmid = (cmin + cmax) * 0.5 - eye  # [C,3]
    chalf = (cmax - cmin) * 0.5
    t, p = planes.shape[0], planes.shape[1]
    n = planes.reshape(t * p, 3)
    a = torch.cat([n, n.abs()], dim=1)  # [T*5, 6]
    b = torch.cat([cmid, chalf], dim=1).T  # [6, C]
    d = (a @ b).reshape(t, p, -1)  # [T,5,C]
    return d.amin(dim=1) >= 0.0
