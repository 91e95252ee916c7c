"""Swept-beam occlusion culling for directional lights (counterpart of
`raytracercuda_tpu/trace/occlusion_cull.py:41-113`).

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


def _beam(omin, omax, tile_any, light_dir) -> SweptBeam:
    u_ax, v_ax, l = light_basis(light_dir)
    ou_lo, ou_hi = box_interval(omin, omax, u_ax)
    ov_lo, ov_hi = box_interval(omin, omax, v_ax)
    ol_lo, _ = box_interval(omin, omax, l)
    return SweptBeam(u_ax=u_ax, v_ax=v_ax, l=l, ou_lo=ou_lo, ou_hi=ou_hi,
                     ov_lo=ov_lo, ov_hi=ov_hi, ol_lo=ol_lo,
                     tile_any=tile_any)


def swept_tile_beams(o_tiles: torch.Tensor, a_tiles: torch.Tensor,
                     light_dir: torch.Tensor) -> SweptBeam:
    """Per-tile beams from row-major ``[T, R, 3]`` origins + ``[T, R]``
    bool active."""
    big = 3.0e37
    act = a_tiles[..., None]
    omin = torch.where(act, o_tiles, big).amin(dim=1)  # [T,3]
    omax = torch.where(act, o_tiles, -big).amax(dim=1)
    return _beam(omin, omax, a_tiles.any(dim=1), light_dir)


def swept_tile_beams_planar(o3_tiles: torch.Tensor, a_tiles: torch.Tensor,
                            light_dir: torch.Tensor) -> SweptBeam:
    """Per-tile beams from planar ``[T, 3, R]`` origins + ``[T, R]`` bool
    active."""
    big = 3.0e37
    act = a_tiles[:, None, :]
    omin = torch.where(act, o3_tiles, big).amin(dim=2)  # [T,3]
    omax = torch.where(act, o3_tiles, -big).amax(dim=2)
    return _beam(omin, omax, a_tiles.any(dim=1), light_dir)


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


def beam_cannot_occlude(beam: SweptBeam, bmin: torch.Tensor,
                        bmax: torch.Tensor) -> torch.Tensor:
    """``[T]`` bool: per-tile boxes ``[T, 3]`` that cannot occlude their
    tile (the walk-side dual of `beam_survive_matrix`)."""
    nu_lo, nu_hi = box_interval(bmin, bmax, beam.u_ax)
    nv_lo, nv_hi = box_interval(bmin, bmax, beam.v_ax)
    _, nl_hi = box_interval(bmin, bmax, beam.l)
    miss_u = (nu_hi < beam.ou_lo) | (nu_lo > beam.ou_hi)
    miss_v = (nv_hi < beam.ov_lo) | (nv_lo > beam.ov_hi)
    behind = nl_hi < beam.ol_lo
    return miss_u | miss_v | behind | ~beam.tile_any
