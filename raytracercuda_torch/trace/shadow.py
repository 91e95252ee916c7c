"""Directional-light occlusion through a light-space 2D grid (counterpart
of `raytracercuda_tpu/trace/shadow.py`), plain PyTorch.

Shadow rays toward a directional light share one direction, so every
triangle is projected onto the plane perpendicular to the light and
rasterized by its 2D box into a uniform ``res`` x ``res`` grid over the
projected scene (sort, then CSR, as `accel/grid.py`).  A query reads the
one cell under its origin's projection, clamped to the grid's border, and
tests the cell's triangles along the light with the oracle's
Möller-Trumbore; a triangle whose box spans more than
``max_cells_per_face`` cells goes to the overflow bucket, which every ray
tests, so the answer stays exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TraceConfig
from ..ops.math import cross, dot_fused, tri_intersect
from ..types import FLT_MAX
from ..utils.profiler import host_sync


def light_basis(light_dir: torch.Tensor):
    """Orthonormal (u, v, l) with l along the light direction."""
    l = light_dir / torch.linalg.vector_norm(light_dir)
    # Two copies from host memory: each waits for the device's queue.
    with host_sync("sync.light_basis", 2):
        ex = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                          device=l.device)
        ey = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                          device=l.device)
    u = cross(l, torch.where(l[0].abs() < 0.9, ex, ey))
    u = u / torch.linalg.vector_norm(u)
    v = cross(l, u)
    return u, v, l


class ShadowGrid(NamedTuple):
    """CSR light-space cell -> triangle table."""

    u_axis: torch.Tensor  # [3]
    v_axis: torch.Tensor  # [3]
    l_axis: torch.Tensor  # [3] unit light direction
    uv_min: torch.Tensor  # [2] the grid's origin in (u, v)
    inv_cell: torch.Tensor  # [2] 1 / cell size
    cell_start: torch.Tensor  # [res * res + 2] int32 CSR offsets; bucket
    #   res * res holds the overflow triangles, tested by every ray
    entry_tris: torch.Tensor  # [E + K, 9] float32 v0|v1|v2 grouped by
    #   cell, then K = max_cells_per_face zero rows, so that a slice of a
    #   round's width from any entry stays in range
    res: int  # cells per axis


def _proj2(p: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """``[..., 3]`` points -> ``[..., 2]`` (u, v) coordinates, rounded as
    the JAX package's ``p @ u`` (`ops/math.dot_fused`): the cells follow
    from them."""
    return torch.stack([dot_fused(p, u), dot_fused(p, v)], dim=-1)


def build_shadow_grid(positions: torch.Tensor, faces: torch.Tensor,
                      light_dir: torch.Tensor, res: int = 128,
                      max_cells_per_face: int = 64) -> ShadowGrid:
    """Project the scene along ``light_dir`` (toward the light, any length)
    and build the 2D CSR grid of ``res`` x ``res`` cells over the
    projected box, on the tensors' device.  A triangle whose 2D box spans
    more than ``max_cells_per_face`` cells goes to the overflow bucket."""
    u, v, l = light_basis(light_dir.to(torch.float32))
    dev = positions.device
    num_faces = faces.shape[0]
    kmax = max_cells_per_face
    v0 = positions[faces[:, 0]]
    v1 = positions[faces[:, 1]]
    v2 = positions[faces[:, 2]]
    p0, p1, p2 = _proj2(v0, u, v), _proj2(v1, u, v), _proj2(v2, u, v)
    tmin = torch.minimum(p0, torch.minimum(p1, p2))  # [F, 2]
    tmax = torch.maximum(p0, torch.maximum(p1, p2))
    uv_min = tmin.amin(dim=0)
    extent = torch.clamp(tmax.amax(dim=0) - uv_min, min=1e-12)
    # A tensor quotient: ``res / extent`` would multiply by a reciprocal.
    inv_cell = torch.full_like(extent, res) / extent

    c0 = torch.clamp((tmin - uv_min) * inv_cell, 0, res - 1).to(torch.int32)
    c1 = torch.clamp((tmax - uv_min) * inv_cell, 0, res - 1).to(torch.int32)
    dims = c1 - c0 + 1
    nx = dims[:, 0:1]
    total = dims[:, 0:1] * dims[:, 1:2]
    num_cells = res * res
    k = torch.arange(kmax, dtype=torch.int32, device=dev)[None, :]
    overflow = total > kmax  # [F, 1]: one entry in the overflow bucket
    valid = (k < total) & ~overflow
    cell = ((c0[:, 1:2] + torch.div(k, nx, rounding_mode="floor")) * res
            + c0[:, 0:1] + torch.remainder(k, nx))
    cell = torch.where(valid, cell, num_cells + 1)  # dropped: sorts last
    cell[:, 0] = torch.where(overflow[:, 0], num_cells, cell[:, 0])

    flat = cell.reshape(-1)
    order = torch.argsort(flat, stable=True)
    cell_start = torch.searchsorted(
        flat[order], torch.arange(num_cells + 2, dtype=flat.dtype,
                                  device=dev)).to(torch.int32)
    face_of = torch.arange(num_faces, device=dev)[:, None].expand(
        num_faces, kmax).reshape(-1)[order]
    tris = torch.cat([v0, v1, v2], dim=1)  # [F, 9]
    entry_tris = torch.cat([tris[face_of],
                            torch.zeros((kmax, 9), dtype=tris.dtype,
                                        device=dev)])
    return ShadowGrid(u_axis=u, v_axis=v, l_axis=l, uv_min=uv_min,
                      inv_cell=inv_cell, cell_start=cell_start,
                      entry_tris=entry_tris, res=res)


def occlusion_grid(grid: ShadowGrid, origins: torch.Tensor,
                   active: torch.Tensor, chunk: int = 32,
                   trace_cfg: TraceConfig = TraceConfig()) -> torch.Tensor:
    """Any hit along the grid's light direction for ``[R, 3]`` origins:
    ``[R]`` bool, True where a triangle lies at ``t_epsilon < t <
    FLT_MAX`` (False where ``active`` is False).  Each ray's cell is read
    ``chunk`` entries a round (contiguous slices of ``entry_tris``), then
    the overflow bucket's; two host syncs a call, for the round counts."""
    res = grid.res
    l = grid.l_axis
    t_eps = float(trace_cfg.t_epsilon)
    dev = origins.device
    # A point off the grid lies in no triangle's box but the clamped
    # border cell's, so clamping it there is exact.
    p = _proj2(origins, grid.u_axis, grid.v_axis)
    c = torch.clamp(torch.floor((p - grid.uv_min) * grid.inv_cell), 0,
                    res - 1).to(torch.int64)
    cid = c[:, 1] * res + c[:, 0]
    start = grid.cell_start[cid].long()
    count = grid.cell_start[cid + 1].long() - start
    last = grid.entry_tris.shape[0] - chunk  # the last slice's first row
    k_off = torch.arange(chunk, device=dev)
    occ = torch.zeros(origins.shape[0], dtype=torch.bool, device=dev)

    def test(first, valid):
        rows = grid.entry_tris[torch.clamp(first, 0, last)[..., None] + k_off]
        t, _, _ = tri_intersect(origins[:, None, :], l, rows[..., 0:3],
                                rows[..., 3:6], rows[..., 6:9])
        return torch.any(valid & (t > t_eps) & (t < float(FLT_MAX)), dim=-1)

    max_count = int(torch.where(active, count, 0).max()) if active.numel() \
        else 0
    for r in range(-(-max_count // chunk)):
        base = r * chunk
        occ |= test(start + base, (base + k_off)[None, :] < count[:, None])

    # The overflow bucket: every ray tests it, one shared slice a round.
    ov = grid.cell_start[res * res:res * res + 2].long().tolist()
    ov_count = ov[1] - ov[0]
    for r in range(-(-ov_count // chunk)):
        first = torch.full((1,), ov[0] + r * chunk, device=dev)
        occ |= test(first, (r * chunk + k_off)[None, :] < ov_count)
    return occ & active
