"""Swept-beam occlusion culling for directional lights (counterpart of
`raytracercuda_tpu/trace/occlusion_cull.py:41-97`).

A tile's shadow rays share one direction, so the tile is a beam: the
active origins' AABB swept along the light.  A box can occlude only if
its projection overlaps the beam's on both axes perpendicular to the
light and it is not entirely behind every origin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .shadow import light_basis


class SweptBeam(NamedTuple):
    """Per-tile swept-origin-box projections onto the light frame."""

    u_ax: torch.Tensor  # [3] unit, perpendicular to the light
    v_ax: torch.Tensor  # [3] unit, perpendicular to the light
    l: torch.Tensor  # [3] unit light direction
    ou_lo: torch.Tensor  # [T] origin-box interval on u_ax
    ou_hi: torch.Tensor
    ov_lo: torch.Tensor  # [T] origin-box interval on v_ax
    ov_hi: torch.Tensor
    ol_lo: torch.Tensor  # [T] origin-box interval start along l
    tile_any: torch.Tensor  # [T] bool — any active ray in the tile


def box_interval(bmin: torch.Tensor, bmax: torch.Tensor, axis: torch.Tensor):
    """Projection interval of AABBs ``[...,3]`` onto a unit ``axis``."""
    c = (bmin + bmax) * 0.5
    h = (bmax - bmin) * 0.5
    pc = c @ axis
    ph = h @ axis.abs()
    return pc - ph, pc + ph


def swept_tile_beams_planar(o3_tiles: torch.Tensor, a_tiles: torch.Tensor,
                            light_dir: torch.Tensor) -> SweptBeam:
    """Per-tile beams from planar ``[T, 3, R]`` origins + ``[T, R]`` bool
    active."""
    big = 3.0e37
    act = a_tiles[:, None, :]
    omin = torch.where(act, o3_tiles, big).amin(dim=2)  # [T,3]
    omax = torch.where(act, o3_tiles, -big).amax(dim=2)
    tile_any = a_tiles.any(dim=1)
    u_ax, v_ax, l = light_basis(light_dir)
    ou_lo, ou_hi = box_interval(omin, omax, u_ax)
    ov_lo, ov_hi = box_interval(omin, omax, v_ax)
    ol_lo, _ = box_interval(omin, omax, l)
    return SweptBeam(u_ax=u_ax, v_ax=v_ax, l=l, ou_lo=ou_lo, ou_hi=ou_hi,
                     ov_lo=ov_lo, ov_hi=ov_hi, ol_lo=ol_lo,
                     tile_any=tile_any)


def beam_survive_matrix(beam: SweptBeam, cmin: torch.Tensor,
                        cmax: torch.Tensor) -> torch.Tensor:
    """``[T, C]`` bool — which boxes each tile beam must test."""
    cu_lo, cu_hi = box_interval(cmin, cmax, beam.u_ax)
    cv_lo, cv_hi = box_interval(cmin, cmax, beam.v_ax)
    _, cl_hi = box_interval(cmin, cmax, beam.l)
    return (
        beam.tile_any[:, None]
        & (cu_hi[None, :] >= beam.ou_lo[:, None])
        & (cu_lo[None, :] <= beam.ou_hi[:, None])
        & (cv_hi[None, :] >= beam.ov_lo[:, None])
        & (cv_lo[None, :] <= beam.ov_hi[:, None])
        & (cl_hi[None, :] >= beam.ol_lo[:, None])
    )
