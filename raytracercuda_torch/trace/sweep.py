"""Tile sweeps: per-tile cluster lists, kernels A, B, C, F and H, and
their plain versions (counterpart of `raytracercuda_tpu/trace/
pallas_sweep.py`, and of `pallas_bounce.py`'s kernel).

Each 16x16 pixel tile gets the list of clusters that survive its cull, in
ascending cluster id.  The kernels live in `csrc/sweep.cu`:

  * A (replacing `pallas_sweep._primary_shade_kernel`) finds each ray's
    closest hit from the common eye over the tile's clusters and
    interpolates the winner's attributes, on planar ``[T, 3, R]``
    directions;
  * F (replacing `pallas_bounce._general_shade_kernel`) is A with planar
    per-ray origins and an activity mask, always with reflectivity; its
    entry point, with the cull that feeds it, is
    `bounce_sweep.trace_shade_general_planar`; C's epilogue over F's sweep
    (`_closest_rays_cuda`) traces ray bundles that are not a pinhole frame
    (`bounce_sweep.trace_rays`);
  * B (replacing `pallas_sweep._occlusion_cols_kernel`) answers any-hit
    along one light direction from planar per-ray origins;
  * C (replacing `pallas_sweep._primary_kernel`) is A without the
    attributes, on row-major ``[T, R, 3]`` directions: t, u, v and the
    winning slot, for the differentiable route;
  * H (replacing `pallas_sweep._occlusion_kernel`) is B on row-major
    ``[T, R, 3]`` origins.

The rules that decide a result are the JAX kernels':

  * a triangle misses when ``|det| < 1.1754944e-38`` or on the u/v window
    tests, and, with ``t_eps``, when ``t < t_eps``;
  * the winner is the smallest t, ties going to the first in ascending
    (cluster, slot) order;
  * a miss carries ``FLT_MAX``, slot 0 and zero attributes.

Every kernel splits each tile's list over many blocks: `split_lists` cuts
the lists into work items of at most ``SHADE_CHUNK`` (A),
``PRIMARY_CHUNK`` (C), ``GENERAL_CHUNK`` (F), ``OCCLUSION_CHUNK`` (B)
or ``OCCLUSION_ROWS_CHUNK`` (H) clusters, one block each, which sweeps
the geometry rows `segment_blocks`.  A's, C's and F's blocks merge their closest hits per
ray with a 64-bit ``atomicMin`` before a second pass writes the outputs
(A's and F's attributes from the shade rows); B's and H's blocks set a
ray's flag at its first hit, and a ray flagged by one item is skipped by
the others (`csrc/sweep.cu`).  One launch is one call of the kernel's C
entry (the key fill or flag clear, and its passes).

Each wrapper runs its plain PyTorch version for tensors on the CPU and
launches its CUDA kernel for tensors on a GPU; there is no fallback from
one to the other.  ``launch_counts`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel.clusters import ClusterSet, edge_rows
from ..config import TraceConfig
from ..models.mesh import VERTEX_DATA_NORMAL, VERTEX_DATA_UV1
from ..ops.cuda_build import kernel_fn, raw_stream
from ..types import FLT_MAX, Hit
from ..utils.profiler import host_sync, span
from .dense import (
    _cull_frustum,
    frustum_planes,
    tile_frustum_planes,
    tile_pixels,
    untile_pixels,
)
from .occlusion_cull import (
    beam_survive_matrix,
    swept_tile_beams,
    swept_tile_beams_planar,
)

# Smallest normal float32: dets below this overflow 1/det to inf, which a
# zero numerator turns into NaN t — treat as degenerate (miss).
_DET_TINY = 1.1754944e-38

#: Attribute columns of a shade block row: 0-8 v0|e1|e2, 9-17 vertex
#: normals, 18-20 albedo, 21 texture id, 22-27 vertex uvs, 28
#: reflectivity, 29-31 zero (rows of 128 bytes, whole 16-byte loads).
SHADE_COLS = 32

#: Columns of a geometry row (the operand of every sweep): v0 | e1 | e2.
GEOM_COLS = 9

#: Kernel launches per wrapper, counted where the kernel is launched.
launch_counts = {"primary_shade": 0, "general_shade": 0, "occlusion": 0,
                 "primary": 0, "occlusion_rows": 0, "closest_rays": 0}

#: Clusters per work item of each kernel, K: the fastest, within the run's
#: spread, of `chip_smoke.py`'s sweep over K on the H100 (PERF.md), by the
#: card's time: on the bench frame and config 5's primary pass (A), config
#: 4 (C, H), the bench frame and config 5's shadows (B) and both of config
#: 5's bounces (F).
SHADE_CHUNK = 1
PRIMARY_CHUNK = 2
GENERAL_CHUNK = 8
OCCLUSION_CHUNK = 1
OCCLUSION_ROWS_CHUNK = 2

#: Tiles a plain version sweeps at once: its ``[n, G, R]`` temporaries then
#: stay near 33 MB each at G = 128, R = 256, whatever the frame size.
_PLAIN_TILES = 256


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Per-scene and per-frame operands.
# ---------------------------------------------------------------------------


def segment_blocks(cs: ClusterSet) -> torch.Tensor:
    """``[C, G, 9]`` float32 geometry rows (v0 | e1 | e2 per sorted slot),
    the operand of every sweep and bit-equal to the shade blocks' first
    nine columns: the cluster set's cached copy, or built from its
    triangles."""
    if cs.tri_blocks is not None:
        return cs.tri_blocks
    return edge_rows(cs.tris).contiguous()


def shade_segment_blocks(cs: ClusterSet, scene) -> tuple[torch.Tensor, bool]:
    """``[C, G, 32]`` float32 shade blocks, one row per sorted slot, in
    the JAX package's column order (see ``SHADE_COLS``).  Padded slots
    carry zero geometry (they miss every ray) and zero attributes; their
    texture id column is the JAX package's, taken from face 0's material.
    Built once per scene."""
    c, g = cs.num_clusters, cs.cluster_size
    order = cs.face_order.clamp(min=0)
    f = scene.faces[order]  # [C*G, 4]
    pad_ok = (cs.face_order >= 0)[:, None].to(torch.float32)

    n = scene.attrs[VERTEX_DATA_NORMAL]
    tris = cs.tris.reshape(c * g, 9)
    v0 = tris[:, 0:3]
    cols = [v0, tris[:, 3:6] - v0, tris[:, 6:9] - v0]
    cols.append(torch.cat([n[f[:, 0]], n[f[:, 1]], n[f[:, 2]]], 1) * pad_ok)
    mat = scene.mesh_material[f[:, 3]]
    cols.append(scene.albedo[mat] * pad_ok)
    cols.append(scene.texture_id[mat].to(torch.float32)[:, None])
    has_uv = VERTEX_DATA_UV1 in scene.attrs
    zeros = torch.zeros((c * g, 6), dtype=torch.float32, device=tris.device)
    if has_uv:
        uv = scene.attrs[VERTEX_DATA_UV1]
        cols.append(torch.cat([uv[f[:, 0], :2], uv[f[:, 1], :2],
                               uv[f[:, 2], :2]], 1) * pad_ok)
    else:
        cols.append(zeros)
    if scene.reflectivity is not None:
        cols.append(scene.reflectivity[mat][:, None] * pad_ok)
    else:
        cols.append(zeros[:, :1])
    cols.append(zeros[:, : SHADE_COLS - 29])
    return torch.cat(cols, dim=1).reshape(c, g, SHADE_COLS).contiguous(), has_uv


def tile_planes_planar(d3_tiles: torch.Tensor, tile_px: int) -> torch.Tensor:
    """Inward bounding planes ``[T, 5, 3]`` of each planar ``[T, 3, R]``
    direction tile's pinhole beam: four corner planes and the mean
    direction (which rejects geometry behind the eye)."""
    r = tile_px * tile_px
    return frustum_planes(d3_tiles[:, :, 0], d3_tiles[:, :, tile_px - 1],
                          d3_tiles[:, :, r - tile_px], d3_tiles[:, :, r - 1],
                          d3_tiles.mean(dim=2))


class TileLists(NamedTuple):
    """Per-tile cluster lists in CSR form: tile ``t`` sweeps clusters
    ``ids[offsets[t]:offsets[t+1]]``, ascending."""

    counts: torch.Tensor  # [T] int32
    offsets: torch.Tensor  # [T+1] int32
    ids: torch.Tensor  # [N] int32


def _tile_lists(survive: torch.Tensor) -> TileLists:
    """Compact the ``[T, C]`` survive mask into per-tile lists.

    Row-major ``nonzero`` yields each tile's ids in ascending order, with
    no cap on a tile's count.  It waits for the device, since the number
    of survivors sizes its output: a sync in the middle of every frame
    that a later change should remove (for example a fixed-capacity list
    written by a kernel): span ``sync.tile_lists``."""
    counts = survive.sum(dim=1, dtype=torch.int32)
    offsets = torch.zeros(survive.shape[0] + 1, dtype=torch.int32,
                          device=survive.device)
    offsets[1:] = torch.cumsum(counts, dim=0)
    with host_sync("sync.tile_lists"):
        ids = survive.nonzero()[:, 1].to(torch.int32)
    return TileLists(counts=counts, offsets=offsets, ids=ids)


def split_lists(lists: TileLists, k: int) -> torch.Tensor:
    """Cut each tile's list into work items of at most ``k`` consecutive
    clusters: ``[3, M]`` int32 rows (tile, first, end), the item covering
    list positions ``[first, end)`` of its tile.  A tile's items follow
    each other in list order.  ``M = T + ceil(N / k)`` bounds the real
    count from the host's shapes alone, so nothing waits for the device;
    the items past the real count are empty (``first == end == 0``)."""
    num_tiles = lists.counts.numel()
    dev = lists.counts.device
    m = num_tiles + -(-lists.ids.numel() // k)
    if num_tiles == 0:
        return torch.zeros((3, m), dtype=torch.int32, device=dev)
    per_tile = (lists.counts + (k - 1)) // k
    last = torch.cumsum(per_tile, dim=0, dtype=torch.int32)  # inclusive
    item = torch.arange(m, dtype=torch.int32, device=dev)
    tile = torch.searchsorted(last, item, right=True, out_int32=True)
    real = tile < num_tiles
    tile = tile.clamp(max=num_tiles - 1)
    first = lists.offsets[tile] + (item - last[tile] + per_tile[tile]) * k
    end = torch.minimum(first + k, lists.offsets[tile + 1])
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return torch.stack([tile, torch.where(real, first, zero),
                        torch.where(real, end, zero)])


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels.
# ---------------------------------------------------------------------------


def _mt_cols(tri, ox, oy, oz, dx, dy, dz, t_eps):
    """Möller–Trumbore with candidates on dim 1 (``[n,G,1]`` v0|e1|e2
    columns) and rays on dim 2 -> t/u/v ``[n,G,R]``; the op order of
    `pallas_sweep._mt_cols`."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = 1.0 / det
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    miss = miss | (det.abs() < _DET_TINY)
    if t_eps is not None:
        miss = miss | (t < t_eps)
    return torch.where(miss, float(FLT_MAX), t), u, v


def _rank_chunks(lists: TileLists, blocks: torch.Tensor):
    """For each list rank ``r``, the tiles listing more than ``r`` clusters,
    at most `_PLAIN_TILES` at a time: ``(tiles, cid, tri)`` with the
    ``r``-th cluster's ids and v0|e1|e2 columns as nine ``[n, G, 1]``
    tensors."""
    max_count = int(lists.counts.max()) if lists.counts.numel() else 0
    for r in range(max_count):
        listing = (lists.counts > r).nonzero()[:, 0]
        for tiles in listing.split(_PLAIN_TILES):
            cid = lists.ids[lists.offsets[tiles].long() + r].long()
            blk = blocks[cid]
            yield tiles, cid, tuple(blk[:, :, k:k + 1] for k in range(9))


def _interpolate_winners(blocks, bt, bs, bu, bv, has_uv, with_refl):
    """The winner's interpolated attributes, as kernel A computes them
    (`pallas_sweep.py:673-685`); zeros where nothing was hit."""
    row = blocks.reshape(-1, SHADE_COLS)[bs.long()]  # [T,R,32]
    hit = bt < FLT_MAX

    def col(k):
        return row[..., k]

    w_ = 1.0 - bu - bv
    outs = [col(9 + k) * w_ + col(12 + k) * bu + col(15 + k) * bv
            for k in range(3)]
    outs += [col(18 + k) for k in range(3)]
    if has_uv:
        outs.append(col(21))
        outs.append(col(22) * w_ + col(24) * bu + col(26) * bv)
        outs.append(col(23) * w_ + col(25) * bu + col(27) * bv)
    if with_refl:
        outs.append(col(28))
    return [torch.where(hit, o, 0.0) for o in outs]


def _closest_plain(lists, origin, d3_tiles, blocks, t_eps):
    """Closest hit of each ray of planar ``[T, 3, R]`` direction tiles from
    the common ``origin [3]`` or planar per-ray origins ``[T, 3, R]``:
    every listed cluster of a tile at once as a ``[G, R]`` rectangle, first
    minimum within the cluster, strict ``<`` across clusters
    (`pallas_sweep.py:664-692`).  Returns ``(t, slot, u, v)`` ``[T, R]``."""
    num_tiles, _, R = d3_tiles.shape
    g = blocks.shape[1]
    dev = d3_tiles.device
    bt = torch.full((num_tiles, R), float(FLT_MAX), device=dev)
    bs = torch.zeros((num_tiles, R), dtype=torch.int32, device=dev)
    bu = torch.zeros((num_tiles, R), device=dev)
    bv = torch.zeros((num_tiles, R), device=dev)
    per_ray = origin.dim() == 3
    d = d3_tiles[:, :, None, :]  # [T,3,1,R]
    if per_ray:
        o = origin[:, :, None, :]
    else:
        ox, oy, oz = origin[0], origin[1], origin[2]
    for tiles, cid, tri in _rank_chunks(lists, blocks):
        dt = d[tiles]
        if per_ray:
            ot = o[tiles]
            ox, oy, oz = ot[:, 0], ot[:, 1], ot[:, 2]
        t, u, v = _mt_cols(tri, ox, oy, oz, dt[:, 0], dt[:, 1], dt[:, 2],
                           t_eps)
        t_blk, j = t.min(dim=1)  # first minimum over the cluster's slots
        better = t_blk < bt[tiles]
        jj = j[:, None, :]
        bt[tiles] = torch.where(better, t_blk, bt[tiles])
        bs[tiles] = torch.where(better, (cid[:, None] * g + j).to(torch.int32),
                                bs[tiles])
        bu[tiles] = torch.where(better, u.gather(1, jj)[:, 0], bu[tiles])
        bv[tiles] = torch.where(better, v.gather(1, jj)[:, 0], bv[tiles])
    return bt, bs, bu, bv


def _primary_shade_plain(lists, eye, d3_tiles, blocks, has_uv, with_refl,
                         t_eps, geom=None):
    """Plain version of kernel A: `_closest_plain` on the shade blocks,
    then the winner's attributes.  ``geom`` (the kernel's geometry rows,
    equal to the blocks' first nine columns) is not needed here."""
    del geom
    bt, bs, bu, bv = _closest_plain(lists, eye, d3_tiles, blocks, t_eps)
    attrs = _interpolate_winners(blocks, bt, bs, bu, bv, has_uv, with_refl)
    return (bt, bs, bu, bv, *attrs)


def _primary_plain(lists, eye, d_tiles, blocks, t_eps):
    """Plain version of kernel C: ``(t, u, v, slot)`` ``[T, R]`` for
    row-major ``[T, R, 3]`` direction tiles over geometry rows."""
    bt, bs, bu, bv = _closest_plain(lists, eye, d_tiles.transpose(1, 2),
                                    blocks, t_eps)
    return bt, bu, bv, bs


def _closest_active_plain(lists, o3_tiles, d3_tiles, active, blocks, t_eps):
    """`_closest_plain` from planar per-ray origins, inactive rays set to
    the miss defaults: ``(t, slot, u, v)`` ``[T, R]``."""
    bt, bs, bu, bv = _closest_plain(lists, o3_tiles, d3_tiles, blocks, t_eps)
    return (torch.where(active, bt, float(FLT_MAX)),
            torch.where(active, bs, 0), torch.where(active, bu, 0.0),
            torch.where(active, bv, 0.0))


def _general_shade_plain(lists, o3_tiles, d3_tiles, active, blocks, has_uv,
                         t_eps, geom=None):
    """Plain version of kernel F: `_closest_active_plain` on the shade
    blocks, then the winner's attributes with reflectivity.  ``geom``
    (the kernel's geometry rows, equal to the blocks' first nine columns)
    is not needed here."""
    del geom
    bt, bs, bu, bv = _closest_active_plain(lists, o3_tiles, d3_tiles, active,
                                           blocks, t_eps)
    attrs = _interpolate_winners(blocks, bt, bs, bu, bv, has_uv, True)
    return (bt, bs, bu, bv, *attrs)


def _closest_rays_plain(lists, o3_tiles, d3_tiles, active, blocks, t_eps):
    """Plain version of C's epilogue over F's sweep: ``(t, u, v, slot)``
    ``[T, R]`` from planar per-ray origins and directions over geometry
    rows, inactive rays set to the miss defaults."""
    bt, bs, bu, bv = _closest_active_plain(lists, o3_tiles, d3_tiles, active,
                                           blocks, t_eps)
    return bt, bu, bv, bs


def _occlusion_plain(lists, light, o3_tiles, active, blocks, t_eps):
    """Plain version of kernel B: any hit along ``light`` from each active
    ray's origin over its tile's listed clusters.  It reads columns 0-8 of
    ``blocks``, so geometry rows and shade rows give the same mask."""
    occ = torch.zeros(active.shape, dtype=torch.bool, device=active.device)
    dx, dy, dz = light[0], light[1], light[2]
    o = o3_tiles[:, :, None, :]  # [T,3,1,R]
    for tiles, _, tri in _rank_chunks(lists, blocks):
        ot = o[tiles]
        t, _, _ = _mt_cols(tri, ot[:, 0], ot[:, 1], ot[:, 2], dx, dy, dz,
                           t_eps)
        occ[tiles] |= (t < FLT_MAX).any(dim=1)
    return occ & active


def _occlusion_rows_plain(lists, light, o_tiles, active, blocks, t_eps):
    """Plain version of kernel H: `_occlusion_plain` on row-major
    ``[T, R, 3]`` origins."""
    return _occlusion_plain(lists, light, o_tiles.transpose(1, 2), active,
                            blocks, t_eps)


# ---------------------------------------------------------------------------
# CUDA launches (kernels in `csrc/sweep.cu`).
# ---------------------------------------------------------------------------


def _check_cuda(name, x, device, dtype, shape):
    if x.device != device or device.type != "cuda" or x.dtype != dtype \
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


def _check_lists(lists: TileLists, device, num_tiles: int):
    _check_cuda("counts", lists.counts, device, torch.int32, (num_tiles,))
    _check_cuda("offsets", lists.offsets, device, torch.int32,
                (num_tiles + 1,))
    _check_cuda("ids", lists.ids, device, torch.int32, (lists.ids.numel(),))


def _check_split(num_rays: int, packs: bool):
    """The split sweep's block is the tile's rays: at most 1024, and a
    multiple of 32 where it packs active rays with warp ballots over
    exactly the tile's rays (F, the ray bundles; B and H round their block
    up instead)."""
    if not 0 < num_rays <= 1024 or (packs and num_rays % 32):
        raise ValueError(f"the split sweep takes 1 to 1024 rays per tile"
                         f"{', a multiple of 32,' if packs else ''} got "
                         f"{num_rays}")


def _eps_args(t_eps):
    return int(t_eps is not None), 0.0 if t_eps is None else float(t_eps)


def _primary_shade_cuda(lists, eye, d3_tiles, blocks, has_uv, with_refl,
                        t_eps, geom):
    """Launch kernel A; outputs as in `_primary_shade_plain`.  Pass 1
    sweeps ``geom``, the geometry rows `segment_blocks` gives; pass 2
    reads the shade rows."""
    num_tiles, _, R = d3_tiles.shape
    c, g = blocks.shape[0], blocks.shape[1]
    dev = d3_tiles.device
    _check_lists(lists, dev, num_tiles)
    _check_cuda("eye", eye, dev, torch.float32, (3,))
    _check_cuda("d3_tiles", d3_tiles, dev, torch.float32, (num_tiles, 3, R))
    _check_cuda("blocks", blocks, dev, torch.float32, (c, g, SHADE_COLS))
    _check_cuda("geom", geom, dev, torch.float32, (c, g, GEOM_COLS))
    _check_split(R, packs=False)
    items = split_lists(lists, SHADE_CHUNK)
    n_f = (12 if has_uv else 9) + (1 if with_refl else 0)
    keys = torch.empty(num_tiles * R, dtype=torch.int64, device=dev)
    out_f = torch.empty((n_f, num_tiles, R), dtype=torch.float32, device=dev)
    out_slot = torch.empty((num_tiles, R), dtype=torch.int32, device=dev)
    err = kernel_fn("rt_primary_shade")(
        items.data_ptr(), items.shape[1], lists.ids.data_ptr(),
        eye.data_ptr(), d3_tiles.data_ptr(), geom.data_ptr(),
        blocks.data_ptr(), num_tiles, R, g, int(has_uv), int(with_refl),
        *_eps_args(t_eps), keys.data_ptr(), out_f.data_ptr(),
        out_slot.data_ptr(), raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel A launch failed: CUDA error {err}")
    launch_counts["primary_shade"] += 1
    return (out_f[0], out_slot, *out_f[1:])


def _launch_occlusion(entry, what, chunk, num_tiles, R, lists, light,
                      origins, active, blocks, t_eps):
    """Launch kernel B or H (C entry ``entry``, work items of ``chunk``
    clusters) on ``origins`` already checked to hold ``num_tiles`` tiles
    of ``R`` rays: ``[T, R]`` bool occlusion."""
    c, g = blocks.shape[0], blocks.shape[1]
    dev = origins.device
    _check_lists(lists, dev, num_tiles)
    _check_cuda("light", light, dev, torch.float32, (3,))
    _check_cuda("active", active, dev, torch.bool, (num_tiles, R))
    _check_cuda("blocks", blocks, dev, torch.float32, (c, g, GEOM_COLS))
    _check_split(R, packs=False)
    items = split_lists(lists, chunk)
    # The kernel reads the bool mask as bytes and writes the bool result.
    occ = torch.empty((num_tiles, R), dtype=torch.bool, device=dev)
    err = kernel_fn(entry)(
        items.data_ptr(), items.shape[1], lists.ids.data_ptr(),
        light.data_ptr(), origins.data_ptr(), active.data_ptr(),
        blocks.data_ptr(), num_tiles, R, g, float(t_eps), occ.data_ptr(),
        raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel {what} launch failed: CUDA error {err}")
    return occ


def _occlusion_cuda(lists, light, o3_tiles, active, blocks, t_eps):
    """Launch kernel B; output as in `_occlusion_plain`.  ``blocks`` are
    geometry rows."""
    num_tiles, _, R = o3_tiles.shape
    _check_cuda("o3_tiles", o3_tiles, o3_tiles.device, torch.float32,
                (num_tiles, 3, R))
    occ = _launch_occlusion("rt_occlusion", "B", OCCLUSION_CHUNK, num_tiles,
                            R, lists, light, o3_tiles, active, blocks, t_eps)
    launch_counts["occlusion"] += 1
    return occ


def _general_shade_cuda(lists, o3_tiles, d3_tiles, active, blocks, has_uv,
                        t_eps, geom=None):
    """Launch kernel F; outputs as in `_general_shade_plain`.  Pass 1
    sweeps ``geom``, the geometry rows `segment_blocks` gives (default:
    a copy of the blocks' first nine columns); pass 2 reads the shade
    rows."""
    num_tiles, _, R = d3_tiles.shape
    c, g = blocks.shape[0], blocks.shape[1]
    dev = d3_tiles.device
    _check_lists(lists, dev, num_tiles)
    _check_cuda("o3_tiles", o3_tiles, dev, torch.float32, (num_tiles, 3, R))
    _check_cuda("d3_tiles", d3_tiles, dev, torch.float32, (num_tiles, 3, R))
    _check_cuda("active", active, dev, torch.bool, (num_tiles, R))
    _check_cuda("blocks", blocks, dev, torch.float32, (c, g, SHADE_COLS))
    if geom is None:
        geom = blocks[:, :, :GEOM_COLS].contiguous()
    _check_cuda("geom", geom, dev, torch.float32, (c, g, GEOM_COLS))
    _check_split(R, packs=True)
    items = split_lists(lists, GENERAL_CHUNK)
    act = active.to(torch.int32)
    n_f = (12 if has_uv else 9) + 1
    keys = torch.empty(num_tiles * R, dtype=torch.int64, device=dev)
    out_f = torch.empty((n_f, num_tiles, R), dtype=torch.float32, device=dev)
    out_slot = torch.empty((num_tiles, R), dtype=torch.int32, device=dev)
    err = kernel_fn("rt_general_shade")(
        items.data_ptr(), items.shape[1], lists.ids.data_ptr(),
        o3_tiles.data_ptr(), d3_tiles.data_ptr(), act.data_ptr(),
        geom.data_ptr(), blocks.data_ptr(), num_tiles, R, g, int(has_uv),
        *_eps_args(t_eps), keys.data_ptr(), out_f.data_ptr(),
        out_slot.data_ptr(), raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel F launch failed: CUDA error {err}")
    launch_counts["general_shade"] += 1
    return (out_f[0], out_slot, *out_f[1:])


def _primary_cuda(lists, eye, d_tiles, blocks, t_eps):
    """Launch kernel C; outputs as in `_primary_plain`."""
    num_tiles, R, _ = d_tiles.shape
    c, g = blocks.shape[0], blocks.shape[1]
    dev = d_tiles.device
    _check_lists(lists, dev, num_tiles)
    _check_cuda("eye", eye, dev, torch.float32, (3,))
    _check_cuda("d_tiles", d_tiles, dev, torch.float32, (num_tiles, R, 3))
    _check_cuda("blocks", blocks, dev, torch.float32, (c, g, GEOM_COLS))
    _check_split(R, packs=False)
    items = split_lists(lists, PRIMARY_CHUNK)
    keys = torch.empty(num_tiles * R, dtype=torch.int64, device=dev)
    out_f = torch.empty((3, num_tiles, R), dtype=torch.float32, device=dev)
    out_slot = torch.empty((num_tiles, R), dtype=torch.int32, device=dev)
    err = kernel_fn("rt_primary")(
        items.data_ptr(), items.shape[1], lists.ids.data_ptr(),
        eye.data_ptr(), d_tiles.data_ptr(), blocks.data_ptr(), num_tiles, R,
        g, *_eps_args(t_eps), keys.data_ptr(), out_f.data_ptr(),
        out_slot.data_ptr(), raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel C launch failed: CUDA error {err}")
    launch_counts["primary"] += 1
    return out_f[0], out_f[1], out_f[2], out_slot


def _closest_rays_cuda(lists, o3_tiles, d3_tiles, active, blocks, t_eps):
    """Launch C's epilogue over F's sweep; outputs as in
    `_closest_rays_plain`.  ``blocks`` are geometry rows."""
    num_tiles, _, R = d3_tiles.shape
    c, g = blocks.shape[0], blocks.shape[1]
    dev = d3_tiles.device
    _check_lists(lists, dev, num_tiles)
    _check_cuda("o3_tiles", o3_tiles, dev, torch.float32, (num_tiles, 3, R))
    _check_cuda("d3_tiles", d3_tiles, dev, torch.float32, (num_tiles, 3, R))
    _check_cuda("active", active, dev, torch.bool, (num_tiles, R))
    _check_cuda("blocks", blocks, dev, torch.float32, (c, g, GEOM_COLS))
    _check_split(R, packs=True)
    items = split_lists(lists, GENERAL_CHUNK)
    act = active.to(torch.int32)
    keys = torch.empty(num_tiles * R, dtype=torch.int64, device=dev)
    out_f = torch.empty((3, num_tiles, R), dtype=torch.float32, device=dev)
    out_slot = torch.empty((num_tiles, R), dtype=torch.int32, device=dev)
    err = kernel_fn("rt_closest_rays")(
        items.data_ptr(), items.shape[1], lists.ids.data_ptr(),
        o3_tiles.data_ptr(), d3_tiles.data_ptr(), act.data_ptr(),
        blocks.data_ptr(), num_tiles, R, g, *_eps_args(t_eps),
        keys.data_ptr(), out_f.data_ptr(), out_slot.data_ptr(),
        raw_stream(dev))
    if err:
        raise RuntimeError(f"ray-bundle sweep launch failed: CUDA error {err}")
    launch_counts["closest_rays"] += 1
    return out_f[0], out_f[1], out_f[2], out_slot


def _occlusion_rows_cuda(lists, light, o_tiles, active, blocks, t_eps):
    """Launch kernel H; output as in `_occlusion_rows_plain`."""
    num_tiles, R, _ = o_tiles.shape
    _check_cuda("o_tiles", o_tiles, o_tiles.device, torch.float32,
                (num_tiles, R, 3))
    occ = _launch_occlusion("rt_occlusion_rows", "H", OCCLUSION_ROWS_CHUNK,
                            num_tiles, R, lists, light, o_tiles, active,
                            blocks, t_eps)
    launch_counts["occlusion_rows"] += 1
    return occ


def _pick(x: torch.Tensor, plain, cuda):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"no kernel for tensors on {x.device}")


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def t_eps_of(trace_cfg: TraceConfig):
    """The kernels' ``t_eps``: ``t_epsilon`` as float32 when backward hits
    are clipped, else None."""
    return (np.float32(trace_cfg.t_epsilon) if trace_cfg.clip_backward_hits
            else None)


def trace_shade_tiles_planar(
    cs: ClusterSet,
    shade_blocks: torch.Tensor,
    has_uv: bool,
    eye: torch.Tensor,
    d3_tiles: torch.Tensor,
    tile_px: int = 16,
    trace_cfg: TraceConfig = TraceConfig(),
    with_refl: bool = False,
):
    """Closest hit plus interpolated attributes on planar ``[T, 3, R]``
    direction tiles from the common origin ``eye``.

    Returns planar ``[T, R]`` tensors ``(t, slot, u, v, nx, ny, nz, ar,
    ag, ab[, tex, tu, tv][, refl])``; slot is int32, the rest float32."""
    with span("sweep.cull"):
        planes = tile_planes_planar(d3_tiles, tile_px)
        lists = _tile_lists(_cull_frustum(planes, eye, cs.cmin, cs.cmax))
    with span("sweep.A"):
        run = _pick(d3_tiles, _primary_shade_plain, _primary_shade_cuda)
        return run(lists, eye.to(torch.float32).contiguous(),
                   d3_tiles.contiguous(), shade_blocks, has_uv, with_refl,
                   t_eps_of(trace_cfg), segment_blocks(cs))


def occlusion_tiles_planar(
    cs: ClusterSet,
    o3_tiles: torch.Tensor,
    light_dir: torch.Tensor,
    a_tiles: torch.Tensor,
    tile_px: int = 16,
    trace_cfg: TraceConfig = TraceConfig(),
) -> torch.Tensor:
    """Directional-light any-hit on planar tiles: ``o3_tiles [T,3,R]`` +
    ``a_tiles [T,R]`` bool -> ``[T,R]`` bool occlusion, false where
    inactive.  The lists come from the swept-beam cull; the sweep runs
    along ``beam.l``, the light direction that `light_basis`
    re-normalises, over the geometry rows `segment_blocks(cs)`."""
    with span("sweep.shadow_cull"):
        beam = swept_tile_beams_planar(o3_tiles, a_tiles, light_dir)
        lists = _tile_lists(beam_survive_matrix(beam, cs.cmin, cs.cmax))
    with span("sweep.B"):
        run = _pick(o3_tiles, _occlusion_plain, _occlusion_cuda)
        occ = run(lists, beam.l.to(torch.float32).contiguous(),
                  o3_tiles.contiguous(), a_tiles.contiguous(),
                  segment_blocks(cs), np.float32(trace_cfg.t_epsilon))
        return occ & a_tiles


def trace_tiles(
    cs: ClusterSet,
    tri_blocks: torch.Tensor,
    eye: torch.Tensor,
    d_tiles: torch.Tensor,
    tile_px: int = 16,
    trace_cfg: TraceConfig = TraceConfig(),
) -> Hit:
    """Closest hit on row-major ``[T, R, 3]`` direction tiles from the
    common origin ``eye`` -> `Hit` with ``[T*R]`` fields in tile order;
    ``face`` is the winner's original face id (int32), -1 on a miss.
    ``tri_blocks`` is `segment_blocks(cs)`."""
    with span("sweep.cull"):
        planes = tile_frustum_planes(d_tiles, tile_px)
        lists = _tile_lists(_cull_frustum(planes, eye, cs.cmin, cs.cmax))
    with span("sweep.C"):
        run = _pick(d_tiles, _primary_plain, _primary_cuda)
        bt, bu, bv, bs = (x.reshape(-1) for x in run(
            lists, eye.to(torch.float32).contiguous(), d_tiles.contiguous(),
            tri_blocks, t_eps_of(trace_cfg)))
    # A miss already carries FLT_MAX, u = v = 0 and slot 0.
    face = torch.where(bt < FLT_MAX, cs.face_order[bs.long()], -1)
    return Hit(t=bt, u=bu, v=bv, face=face.to(torch.int32))


def trace_dense(
    cs: ClusterSet,
    tri_blocks: torch.Tensor,
    eye: torch.Tensor,
    dirs: torch.Tensor,
    height: int,
    width: int,
    tile_px: int = 16,
    trace_cfg: TraceConfig = TraceConfig(),
) -> Hit:
    """Closest hit for a pinhole frame: row-major ``[H*W, 3]`` directions
    in, row-major ``[H*W]`` `Hit` fields out."""
    d_tiles = tile_pixels(dirs, height, width, tile_px)
    hit = trace_tiles(cs, tri_blocks, eye, d_tiles, tile_px, trace_cfg)
    num_tiles = d_tiles.shape[0]

    def unt(x):
        return untile_pixels(x.reshape(num_tiles, -1), height, width,
                             tile_px)

    return Hit(t=unt(hit.t), u=unt(hit.u), v=unt(hit.v), face=unt(hit.face))


def occlusion_tiles(
    cs: ClusterSet,
    tri_blocks: torch.Tensor,
    o_tiles: torch.Tensor,
    light_dir: torch.Tensor,
    a_tiles: torch.Tensor,
    tile_px: int = 16,
    trace_cfg: TraceConfig = TraceConfig(),
) -> torch.Tensor:
    """Directional-light any-hit on row-major tiles: ``o_tiles [T,R,3]`` +
    ``a_tiles [T,R]`` bool -> ``[T*R]`` bool in tile order, false where
    inactive.  Always clipped at ``t_epsilon``; the sweep runs along
    ``beam.l``, the light direction that `light_basis` re-normalises."""
    with span("sweep.shadow_cull"):
        beam = swept_tile_beams(o_tiles, a_tiles, light_dir)
        lists = _tile_lists(beam_survive_matrix(beam, cs.cmin, cs.cmax))
    with span("sweep.H"):
        run = _pick(o_tiles, _occlusion_rows_plain, _occlusion_rows_cuda)
        occ = run(lists, beam.l.to(torch.float32).contiguous(),
                  o_tiles.contiguous(), a_tiles.contiguous(), tri_blocks,
                  np.float32(trace_cfg.t_epsilon))
        return (occ & a_tiles).reshape(-1)


def occlusion_dense(
    cs: ClusterSet,
    tri_blocks: torch.Tensor,
    origins: torch.Tensor,
    light_dir: torch.Tensor,
    active: torch.Tensor,
    height: int,
    width: int,
    tile_px: int = 16,
    trace_cfg: TraceConfig = TraceConfig(),
) -> torch.Tensor:
    """Any-hit occlusion for a directional light on row-major pixels:
    ``origins [H*W, 3]`` + ``active [H*W]`` -> ``[H*W]`` bool."""
    o_tiles = tile_pixels(origins, height, width, tile_px)
    a_tiles = tile_pixels(active, height, width, tile_px)
    occ = occlusion_tiles(cs, tri_blocks, o_tiles, light_dir, a_tiles,
                          tile_px, trace_cfg)
    return untile_pixels(occ.reshape(o_tiles.shape[0], -1), height, width,
                         tile_px)
