"""Render target: the packed framebuffer as a tensor (counterpart of
`raytracercuda_tpu/models/render_target.py`).

The reference maps an OpenGL buffer with lock/unlock and keeps a
process-global current target (`RenderTarget.cpp:53-91`).  Here the
target is a ``torch.uint32`` tensor of packed pixels on one device; lock
and unlock keep the reference's state machine and error codes, and the
class-level current target stands for ``RenderTarget::get()``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..errors import ERROR_ALL_FINE, ERROR_LOCK_FIRST, ERROR_UNLOCK_FIRST


class RenderTarget:
    _current: Optional["RenderTarget"] = None

    def __init__(self, width: int, height: int,
                 device: torch.device | str | None = None):
        self.width = int(width)
        self.height = int(height)
        self.pitch = self.width * 4  # bytes per row, RGBA8 as in the GL TBO
        self.device = resolve_device(device)
        self.buffer = torch.zeros(self.width * self.height,
                                  dtype=torch.uint32, device=self.device)
        self._locked = False

    @staticmethod
    def create(width: int, height: int,
               device: torch.device | str | None = None) -> "RenderTarget":
        """Allocate a ``width x height`` framebuffer on ``device`` (the card
        when None)."""
        return RenderTarget(width, height, device)

    def lock(self) -> int:
        """Map for writing: becomes the current target; locking twice is
        error 6."""
        if self._locked:
            return ERROR_UNLOCK_FIRST
        self._locked = True
        RenderTarget._current = self
        return ERROR_ALL_FINE

    def unlock(self) -> int:
        """Unmap; unlocking an unlocked target is error 7."""
        if not self._locked:
            return ERROR_LOCK_FIRST
        self._locked = False
        if RenderTarget._current is self:
            RenderTarget._current = None
        return ERROR_ALL_FINE

    @property
    def locked(self) -> bool:
        return self._locked

    @staticmethod
    def get() -> Optional["RenderTarget"]:
        """The current (locked) target, or None."""
        return RenderTarget._current

    def image(self) -> torch.Tensor:
        """The framebuffer as ``[H, W]`` packed pixels."""
        return self.buffer.reshape(self.height, self.width)
