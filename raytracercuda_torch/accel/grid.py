"""Hashed uniform grid: the deterministic CSR build (counterpart of
`raytracercuda_tpu/accel/grid.py`, the reference's spatial hash,
`Raytracer/Hash.cu`, `SceneHash.cpp`).

Points quantize to ``cell_res``-sized cells; a cell hashes to one of
``num_cells`` buckets by the sum of a per-coordinate Fletcher16 checksum
(`Hash.cu:17-54`); a triangle goes into every cell of its box that the
SAT test says it overlaps (`Hash.cu:132-178`), at most
``max_cells_per_face`` cells in x-fastest order (the reference loops over
every cell; a large triangle loses the rest, as in the JAX package).  The
(bucket, face) pairs are sorted by bucket, stably, and indexed with
`searchsorted`: plain PyTorch on the structure's device, bit for bit the
JAX package's table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import GridConfig
from ..ops.tribox import tri_box_overlap


class HashGrid(NamedTuple):
    """CSR bucket -> face table."""

    cell_start: torch.Tensor  # [num_cells + 1] int32 CSR offsets
    entries: torch.Tensor  # [E] int32 face ids grouped by bucket; the
    #   pairs the build dropped (outside the triangle or beyond the cap)
    #   sort last, in the sentinel bucket num_cells
    cell_res: torch.Tensor  # scalar float32
    num_cells: int


def fletcher16(h: torch.Tensor) -> torch.Tensor:
    """``bmHash`` (`Hash.cu:17-32`): Fletcher16 over the four little-endian
    bytes b0..b3 of a u32 (given as int64 in [0, 2^32)), ``(sum2 << 8) |
    sum1`` (< 65536), int64.  The reference reduces both running sums mod
    255 after each byte; the same sums reduced once, ``sum1 = (b0 + b1 +
    b2 + b3) % 255`` and ``sum2 = (4 b0 + 3 b1 + 2 b2 + b3) % 255``, are
    equal and take a few tensor operations instead of 24."""
    shifts = torch.tensor([0, 8, 16, 24], device=h.device)
    weights = torch.tensor([4, 3, 2, 1], device=h.device)
    b = (h[..., None] >> shifts) & 0xFF
    s1 = b.sum(dim=-1) % 255
    s2 = (b * weights).sum(dim=-1) % 255
    return (s2 << 8) | s1


def hash3_cells(cells: torch.Tensor, num_cells: int) -> torch.Tensor:
    """``bmHash3`` (`Hash.cu:40-46`): the per-axis Fletcher16 sums mod
    ``num_cells``, int64.  Integer cells go through the two's-complement
    u32 cast of the reference's ``make_uint3``, done in int64."""
    u = cells.to(torch.int64) & 0xFFFFFFFF
    return fletcher16(u).sum(dim=-1) % num_cells


def map_cell(p: torch.Tensor, cell_res) -> torch.Tensor:
    """``bmMap3`` (`Hash.cu:56-64`): floor(p / cell_res) as int32, an IEEE
    division on every device (``cell_res`` goes to ``p``'s device first: a
    CPU scalar would make the card multiply by its reciprocal)."""
    res = torch.as_tensor(cell_res, dtype=torch.float32, device=p.device)
    return torch.floor(p / res).to(torch.int32)


def build_grid(positions: torch.Tensor, faces: torch.Tensor,
               cfg: GridConfig = GridConfig()) -> HashGrid:
    """Rasterize each face over its box's cells, SAT-test each cell
    (`Hash.cu:146-177`) and build the CSR table, on the tensors' device.

    The JAX package's build runs under ``jit``, where XLA turns its
    division by the constant ``cell_res`` into a product with the float32
    reciprocal; the cells here are quantized the same way, so that both
    tables are equal bit for bit."""
    dev = positions.device
    res = torch.tensor(cfg.cell_res, dtype=torch.float32, device=dev)
    inv_res = float(np.float32(1.0) / np.float32(cfg.cell_res))
    num_faces = faces.shape[0]
    kmax = cfg.max_cells_per_face

    v0 = positions[faces[:, 0]]
    v1 = positions[faces[:, 1]]
    v2 = positions[faces[:, 2]]
    tmin = torch.minimum(v0, torch.minimum(v1, v2))
    tmax = torch.maximum(v0, torch.maximum(v1, v2))
    c0 = torch.floor(tmin * inv_res).to(torch.int32)  # [F, 3] inclusive
    c1 = torch.floor(tmax * inv_res).to(torch.int32)
    dims = c1 - c0 + 1
    nx, ny = dims[:, 0:1], dims[:, 1:2]
    total = dims[:, 0:1] * dims[:, 1:2] * dims[:, 2:3]

    # Up to kmax candidate cells a face, x fastest (`Hash.cu:162-177`).
    k = torch.arange(kmax, dtype=torch.int32, device=dev)[None, :]  # [1, K]
    valid = k < total
    dx = torch.remainder(k, nx)
    dy = torch.remainder(torch.div(k, nx, rounding_mode="floor"), ny)
    dz = torch.div(k, nx * ny, rounding_mode="floor")
    cell = torch.stack([c0[:, 0:1] + dx, c0[:, 1:2] + dy, c0[:, 2:3] + dz],
                       dim=-1)  # [F, K, 3]

    # The SAT test of the candidates only (a small face has a few of its
    # kmax); the others go to the sentinel bucket with the misses.
    face, slot = torch.nonzero(valid, as_tuple=True)
    cand = cell[face, slot]
    bmin = cand.to(torch.float32) * res
    bmax = bmin + res
    overlap = tri_box_overlap((bmin + bmax) * 0.5, (bmax - bmin) * 0.5,
                              v0[face], v1[face], v2[face])
    bucket = torch.full((num_faces, kmax), cfg.num_cells, dtype=torch.int64,
                        device=dev)
    bucket[face, slot] = torch.where(overlap,
                                     hash3_cells(cand, cfg.num_cells),
                                     cfg.num_cells)
    bucket = bucket.reshape(-1)
    face_ids = torch.arange(num_faces, dtype=torch.int32,
                            device=dev)[:, None].expand(num_faces, kmax)
    order = torch.argsort(bucket, stable=True)
    cell_start = torch.searchsorted(
        bucket[order],
        torch.arange(cfg.num_cells + 1, dtype=torch.int64, device=dev))
    return HashGrid(cell_start=cell_start.to(torch.int32),
                    entries=face_ids.reshape(-1)[order].contiguous(),
                    cell_res=res, num_cells=cfg.num_cells)
