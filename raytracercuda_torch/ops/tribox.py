"""Separating-axis triangle/box overlap over broadcast batches (counterpart
of `raytracercuda_tpu/ops/tribox.py`, the reference's Akenine-Möller test,
`Raytracer/BoxTriangle.cuh:57-222`).

All 13 axes are evaluated without early outs: the nine cross products of
an edge with a coordinate axis, the three box face normals (the
triangle's box against the box) and the triangle's normal.

The JAX package's test, compiled by XLA on the CPU, contracts each
projection's three-term sum into fused multiply-adds
(`ops/math.dot_fused`) and each term of the normal's cross product into
``fma(a1, b2, -(a2 * b1))``.  A triangle that touches a cell's box within
a rounding error is in or out by those roundings, so the port rounds the
same way (`ops/math.fma32`), and the hash grid's table is the JAX
package's bit for bit, on the CPU and on the card alike.
"""

from __future__ import annotations

import torch

from .math import dot_fused, fma32


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`ops.math.cross` with each term contracted."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([fma32(a1, b2, -(a2 * b1)), fma32(a2, b0, -(a0 * b2)),
                        fma32(a0, b1, -(a1 * b0))], dim=-1)


def _axis_separates(axis, v0, v1, v2, half):
    """True where ``axis`` separates the (box-centred) triangle from the
    box: the triangle's projection lies beyond the box's radius
    ``sum(|axis| * half)``."""
    p0, p1, p2 = dot_fused(axis, v0), dot_fused(axis, v1), dot_fused(axis, v2)
    lo = torch.minimum(p0, torch.minimum(p1, p2))
    hi = torch.maximum(p0, torch.maximum(p1, p2))
    rad = dot_fused(axis.abs(), half)
    return (lo > rad) | (hi < -rad)


def tri_box_overlap(box_center, box_half, t0, t1, t2):
    """True where the triangle ``t0, t1, t2`` overlaps the box of centre
    ``box_center`` and half-extent ``box_half``; all ``[..., 3]``,
    broadcast together (`BoxTriangle.cuh:134-222`)."""
    box_center, box_half, t0, t1, t2 = torch.broadcast_tensors(
        box_center, box_half, t0, t1, t2)
    v0 = t0 - box_center
    v1 = t1 - box_center
    v2 = t2 - box_center
    e0 = v1 - v0
    e1 = v2 - v1
    e2 = v0 - v2
    zeros = torch.zeros_like(v0[..., 0])
    separated = torch.zeros_like(zeros, dtype=torch.bool)
    for e in (e0, e1, e2):
        # cross(e, x), cross(e, y), cross(e, z) up to sign (SAT ignores it).
        for axis in (torch.stack([zeros, e[..., 2], -e[..., 1]], dim=-1),
                     torch.stack([-e[..., 2], zeros, e[..., 0]], dim=-1),
                     torch.stack([e[..., 1], -e[..., 0], zeros], dim=-1)):
            separated |= _axis_separates(axis, v0, v1, v2, box_half)
    # The box's face normals: the triangle's box against the box.
    tri_min = torch.minimum(v0, torch.minimum(v1, v2))
    tri_max = torch.maximum(v0, torch.maximum(v1, v2))
    separated |= torch.any((tri_min > box_half) | (tri_max < -box_half),
                           dim=-1)
    # The triangle's plane against the box: overlap iff |n . v0| <=
    # sum(half * |n|).
    normal = _cross(e0, e1)
    separated |= dot_fused(normal, v0).abs() > dot_fused(normal.abs(), box_half)
    return ~separated
