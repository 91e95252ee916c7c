"""Vectorized device math on torch tensors (counterpart of
`raytracercuda_tpu/ops/math.py`).

Packed ``0x00RRGGBB`` colours are ``torch.uint32``, 4 bytes a pixel, as the
JAX package's.  torch has little uint32 arithmetic (no shifts, no indexed
writes), so the packing is done on ``torch.int32``, which holds the same
bits, and the result is handed out as its free ``.view(torch.uint32)``.
"""

from __future__ import annotations

import torch

from ..types import FLT_MAX


def as_u32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> the packed ``torch.uint32`` frame (a view)."""
    return bits.view(torch.uint32)


def as_bits(packed: torch.Tensor) -> torch.Tensor:
    """A packed ``torch.uint32`` frame -> its int32 bits (a view), for the
    arithmetic that uint32 lacks."""
    return packed.view(torch.int32)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    # Clip, then truncate toward zero through int32 (the CUDA reference's
    # u32 cast of a clamped value).
    return torch.clamp(x, 0.0, 255.0).to(torch.int32)


def pack_rgb(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float [0,1] channels -> packed ``0x00RRGGBB`` (uint32)."""
    return as_u32((_to_u8(r * 255.0) << 16) | (_to_u8(g * 255.0) << 8)
                  | _to_u8(b * 255.0))


def pack_rgb_vec(v: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` float RGB -> packed ``0x00RRGGBB`` (uint32)."""
    return pack_rgb(v[..., 0], v[..., 1], v[..., 2])


def pack_gray(r: torch.Tensor) -> torch.Tensor:
    """One float channel -> packed gray ``0x00RRGGBB`` (uint32)."""
    ru = _to_u8(r * 255.0)
    return as_u32((ru << 16) | (ru << 8) | ru)


def unpack_rgb(packed: torch.Tensor) -> torch.Tensor:
    """Packed colour (uint32, or any integer tensor of the same bits) ->
    float ``[...,3]`` RGB in [0,1]."""
    p = as_bits(packed) if packed.dtype == torch.uint32 else packed
    r = ((p >> 16) & 0xFF).to(torch.float32) / 255.0
    g = ((p >> 8) & 0xFF).to(torch.float32) / 255.0
    b = (p & 0xFF).to(torch.float32) / 255.0
    return torch.stack([r, g, b], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis, with the JAX package's term
    order (``a1*b2 - a2*b1``, ...)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add: the
    product and the sum in float64, where the product of two float32
    values is exact."""
    return (a.double() * b.double() + c.double()).float()


def dot_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot product over a trailing axis of 3 as XLA on the CPU
    computes the JAX package's three-term sums and matrix-vector products:
    ``fma(a2, b2, fma(a1, b1, a0 * b0))``.  Where a rounding decides a
    discrete result (a cell, an overlap), the port computes it so."""
    return fma32(a[..., 2], b[..., 2],
                 fma32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = torch.sqrt(torch.clamp(dot(v, v), min=eps))
    return v / n[..., None]


def tri_intersect(orig, direction, v0, v1, v2):
    """Möller–Trumbore, broadcastable over ``[...,3]`` operands
    (`bmTriIntersect`, `CudaComon.cuh:117-155`).  Returns ``(t, u, v)``
    with ``t == FLT_MAX`` on miss; no positivity check on t."""
    v0v1 = v1 - v0
    v0v2 = v2 - v0
    pvec = cross(direction, v0v2)
    det = dot(v0v1, pvec)
    inv_det = 1.0 / det
    tvec = orig - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, v0v1)
    v = dot(direction, qvec) * inv_det
    t = dot(v0v2, qvec) * inv_det
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    miss = miss | torch.isnan(u) | torch.isnan(v) | torch.isnan(t)
    t = torch.where(miss, torch.full_like(t, float(FLT_MAX)), t)
    return t, u, v


def box_ray_intersect(bmin, bmax, orig, inv_dir):
    """Slab test (`bmBoxRayIntersect`, `CudaComon.cuh:158-172`): the entry
    distance, clamped to 0 when the origin is inside; FLT_MAX on a miss.
    A NaN slab product (0 * inf) misses, as the JAX package's NaN-
    propagating min/max make it."""
    t_min = (bmin - orig) * inv_dir
    t_max = (bmax - orig) * inv_dir
    t_far = torch.amin(torch.maximum(t_min, t_max), dim=-1)
    t_near = torch.amax(torch.minimum(t_min, t_max), dim=-1)
    dist = torch.clamp(t_near, min=0.0)
    dist = torch.where(t_far >= t_near, dist, float(FLT_MAX))
    return torch.where(t_far < 0.0, float(FLT_MAX), dist)


def box_ray_intersect_no_zero(bmin, bmax, orig, inv_dir):
    """Slab test returning the exit distance where the entry distance is
    behind the origin or infinite (`bmBoxRayIntersectNoZero`,
    `CudaComon.cuh:174-187`): how the grid march steps through its cell.
    A NaN slab product (0 * inf) gives a NaN, as the JAX package's
    NaN-propagating min/max do."""
    t_min = (bmin - orig) * inv_dir
    t_max = (bmax - orig) * inv_dir
    t_near = torch.amax(torch.minimum(t_min, t_max), dim=-1)
    t_far = torch.amin(torch.maximum(t_min, t_max), dim=-1)
    return torch.where(torch.isinf(t_near) | (t_near < 0.0), t_far, t_near)


def aabb_overlap(amin, amax, bmin, bmax):
    """Axis-aligned box overlap, touching boxes included (`bmAABBOverlap`,
    `CudaComon.cuh:189-212`)."""
    sep = torch.any(amin > bmax, dim=-1) | torch.any(amax < bmin, dim=-1)
    return ~sep


def validate_aabb(bmin, bmax):
    """True where the box is valid: not every extent negative
    (`bmValidateAABB`, `CudaComon.cuh:214-228`)."""
    return ~torch.all((bmax - bmin) < 0.0, dim=-1)
