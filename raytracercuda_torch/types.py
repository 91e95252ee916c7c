"""Core SoA value types for the PyTorch port.

Counterpart of `raytracercuda_tpu/types.py`: rays are ``[R,3]`` bundles,
hit records are flat ``[R]`` component tensors, and faces are rows of an
``[F,4]`` int table (3 vertex indices + mesh index).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device

# The reference's miss sentinel (`CudaComon.cuh:143,147`).  A numpy scalar,
# as in the JAX package, so that it mixes with tensors of any device.
FLT_MAX = np.float32(3.4028234663852886e38)

# Sentinel for "no face" / invalid index, as in the JAX package.
INVALID_U32 = np.uint32(0xFFFFFFFF)
INVALID_I32 = np.int32(-1)


class Rays(NamedTuple):
    """A bundle of rays: ``origin`` and ``direction`` float32 ``[..., 3]``
    (the direction need not be normalized)."""

    origin: torch.Tensor
    direction: torch.Tensor


class Hit(NamedTuple):
    """Closest-hit record: ``t`` is FLT_MAX on miss, ``face`` is -1."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    face: torch.Tensor  # int32 face id into the scene's flattened face table

    @property
    def hit_mask(self) -> torch.Tensor:
        return self.face >= 0


def miss_hit(shape, device: torch.device | str | None = None) -> Hit:
    """An all-miss `Hit` of the given batch shape, on ``device`` (the card
    when None)."""
    device = resolve_device(device)
    return Hit(t=torch.full(shape, float(FLT_MAX), dtype=torch.float32,
                            device=device),
               u=torch.zeros(shape, dtype=torch.float32, device=device),
               v=torch.zeros(shape, dtype=torch.float32, device=device),
               face=torch.full(shape, -1, dtype=torch.int32, device=device))
