"""Barycentric vertex-attribute interpolation and indexed-face
intersection (counterpart of `raytracercuda_tpu/ops/interpolate.py`):
gather a face's three vertex attributes by index and blend them with
Möller–Trumbore barycentrics, over any leading dims of ``face_ids``."""

from __future__ import annotations

import torch

from .math import tri_intersect


def face_interpolate(attr: torch.Tensor, faces: torch.Tensor,
                     face_ids: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """``a0*w + a1*u + a2*v`` with ``w = 1-(u+v)`` (`bmFaceInterpolate`):
    ``attr [V, k]``, ``faces [F, 4]``, ``face_ids [...]`` (negative ids
    read face 0; callers mask misses) -> ``[..., k]``."""
    f = faces[face_ids.clamp(min=0).long()]
    a0, a1, a2 = attr[f[..., 0]], attr[f[..., 1]], attr[f[..., 2]]
    w = 1.0 - (u + v)
    return a0 * w[..., None] + a1 * u[..., None] + a2 * v[..., None]


def face_ray_intersect(positions: torch.Tensor, faces: torch.Tensor,
                       face_ids: torch.Tensor, orig: torch.Tensor,
                       direction: torch.Tensor):
    """Möller–Trumbore against each ray's face by index
    (`bmFaceRayIntersect`) -> ``(t, u, v)``."""
    f = faces[face_ids.clamp(min=0).long()]
    return tri_intersect(orig, direction, positions[f[..., 0]],
                         positions[f[..., 1]], positions[f[..., 2]])
