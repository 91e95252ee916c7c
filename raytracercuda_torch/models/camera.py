"""Pinhole ray grid, fly-camera orientation and the `Camera` object
(counterpart of `raytracercuda_tpu/models/camera.py`)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..errors import (
    ERROR_ALL_FINE,
    ERROR_INVALID_PARAMETER,
    ERROR_NO_RENDER_TARGET,
)
from ..utils.profiler import span


def camera_ray_grid(
    width: int,
    height: int,
    left: float = -1.0,
    right: float = 1.0,
    top: float = 1.0,
    bottom: float = -1.0,
    zoom: float = 1.0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Normalized pinhole ray directions, ``[height*width, 3]`` float32, on
    ``device`` (the card when None).

    Pixel centres at half-step offsets, direction ``(rx, ry, zoom) /
    sqrt(zoom^2 + rx^2 + ry^2)``, row-major with y outer; the same
    float32 operations in the same order as the JAX package."""
    device = resolve_device(device)
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


class Camera:
    """Host-side camera (``ICamera``): a precomputed pinhole ray grid on
    ``device``; status codes as the reference returns them."""

    def __init__(self, device: torch.device | str | None = None) -> None:
        # The reference's defaults, 1000x1000 (`Camera.cpp:33-36`).
        self.width = 1000
        self.height = 1000
        self.device = resolve_device(device)
        self.initial_rays: Optional[torch.Tensor] = None

    @staticmethod
    def create(device: torch.device | str | None = None) -> "Camera":
        return Camera(device)

    def set_initial_rays(self, width: int, height: int, left: float = -1.0,
                         right: float = 1.0, top: float = 1.0,
                         bottom: float = -1.0, zoom: float = 1.0) -> int:
        """Build the ray grid: error 2 on a zero size or a grid that is not
        finite (`Camera.cpp:43-72`), else 0."""
        if width == 0 or height == 0:
            return ERROR_INVALID_PARAMETER
        if not np.isfinite(np.sqrt(zoom * zoom)):
            return ERROR_INVALID_PARAMETER
        self.width = int(width)
        self.height = int(height)
        self.initial_rays = camera_ray_grid(width, height, left, right, top,
                                            bottom, zoom, device=self.device)
        if not bool(torch.isfinite(self.initial_rays).all()):
            return ERROR_INVALID_PARAMETER
        return ERROR_ALL_FINE

    def clear(self, render_target, value: int) -> int:
        """Fill ``render_target`` with ``value`` through kernel D: error 8
        without a target, else 0.  Traced, a root span ``api.clear``."""
        if render_target is None:
            return ERROR_NO_RENDER_TARGET
        from ..ops.clear import clear_buffer

        with span("api.clear"):
            render_target.buffer = clear_buffer(
                render_target.width * render_target.height, value,
                render_target.device)
        return ERROR_ALL_FINE

    def trace_scene(self, eye, orient, scene, render_target) -> int:
        """Forward to ``scene.march``: error 2 on a missing argument or a
        camera without rays (`Camera.cpp:85-97`)."""
        if eye is None or orient is None or scene is None:
            return ERROR_INVALID_PARAMETER
        if self.width == 0 or self.height == 0 or self.initial_rays is None:
            return ERROR_INVALID_PARAMETER
        return scene.march(eye, orient, self, render_target)
