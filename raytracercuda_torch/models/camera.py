"""Pinhole ray grid and fly-camera orientation (counterpart of
`raytracercuda_tpu/models/camera.py:25-61`).  The `Camera` object comes
with the public-API slice of the port."""

from __future__ import annotations

import numpy as np
import torch


def camera_ray_grid(
    width: int,
    height: int,
    left: float = -1.0,
    right: float = 1.0,
    top: float = 1.0,
    bottom: float = -1.0,
    zoom: float = 1.0,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Normalized pinhole ray directions, ``[height*width, 3]`` float32.

    Pixel centres at half-step offsets, direction ``(rx, ry, zoom) /
    sqrt(zoom^2 + rx^2 + ry^2)``, row-major with y outer; the same
    float32 operations in the same order as the JAX package."""
    dx = (right - left) / width
    dy = (bottom - top) / height
    rx = left + dx * (torch.arange(width, dtype=torch.float32, device=device)
                      + 0.5)
    ry = top + dy * (torch.arange(height, dtype=torch.float32, device=device)
                     + 0.5)
    gx = rx[None, :].expand(height, width)
    gy = ry[:, None].expand(height, width)
    gz = torch.full((height, width), float(zoom), dtype=torch.float32,
                    device=device)
    d = 1.0 / torch.sqrt(zoom * zoom + gx * gx + gy * gy)
    dirs = torch.stack([gx * d, gy * d, gz * d], dim=-1)
    return dirs.reshape(height * width, 3)


def orient_from_pan_pitch(pan: float, pitch: float) -> np.ndarray:
    """3x3 orientation = yaw(pan, +Y) @ pitch(pitch, +X), column-vector
    convention (dir' = orient @ dir)."""
    cy, sy = np.cos(pan), np.sin(pan)
    cp, sp = np.cos(pitch), np.sin(pitch)
    yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    pit = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return yaw @ pit
