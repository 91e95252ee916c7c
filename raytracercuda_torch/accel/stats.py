"""Acceleration-structure introspection (counterpart of
`raytracercuda_tpu/accel/stats.py`).

Per-structure ``*_stats`` return a plain dict of host-side numbers: the
LBVH's leaf-depth histogram and faces per leaf (the reference's tree dump,
`BuildTree.cu:307-360`), the cluster set's fill and box quality, the hash
grid's bucket occupancy (`Hash.cu:223-228`), and the cluster route's
survivors per tile on a probe frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .bvh import Bvh
from .clusters import ClusterSet
from .grid import HashGrid


def _hist_summary(x: np.ndarray) -> dict:
    if x.size == 0:
        return {"min": 0, "max": 0, "mean": 0.0, "p50": 0, "p95": 0, "p99": 0}
    return {
        "min": int(x.min()), "max": int(x.max()),
        "mean": round(float(x.mean()), 2),
        "p50": int(np.percentile(x, 50)),
        "p95": int(np.percentile(x, 95)),
        "p99": int(np.percentile(x, 99)),
    }


def bvh_stats(bvh: Bvh) -> dict:
    """Leaf-depth histogram and faces per leaf.  Depth is found on the host
    by a stack walk over each internal node's children: its hit link (the
    left child) and the left child's skip link (the right child)."""
    hit = bvh.hit_link.cpu().numpy()
    skip = bvh.skip_link.cpu().numpy()
    is_leaf = bvh.is_leaf.cpu().numpy()
    counts = bvh.leaf_count.cpu().numpy()
    n = hit.shape[0]
    depth = np.full(n, -1, np.int32)
    depth[0] = 0
    stack = [0]
    while stack:
        v = stack.pop()
        if is_leaf[v]:
            continue
        left = hit[v]
        if left < 0 or left >= n:
            continue
        if depth[left] < 0:
            depth[left] = depth[v] + 1
            stack.append(left)
        right = skip[left]
        if 0 <= right < n and depth[right] < 0:
            depth[right] = depth[v] + 1
            stack.append(right)
    leaf_mask = is_leaf & (depth >= 0)
    return {
        "structure": "bvh",
        "nodes": int(n),
        "leaves": int(leaf_mask.sum()),
        "faces": int(bvh.num_faces),
        "leaf_depth": _hist_summary(depth[leaf_mask]),
        "faces_per_leaf": _hist_summary(counts[leaf_mask]),
    }


def cluster_stats(cs: ClusterSet) -> dict:
    """Cluster fill and box quality (the cluster analog of faces/leaf)."""
    face_order = cs.face_order.cpu().numpy().reshape(cs.num_clusters,
                                                     cs.cluster_size)
    fill = (face_order >= 0).sum(axis=1)
    cmin = cs.cmin.cpu().numpy()
    cmax = cs.cmax.cpu().numpy()
    ext = np.maximum(cmax - cmin, 0.0)
    # Surface area drives the expected sweep cost (a SAH-style proxy).
    sa = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                + ext[:, 0] * ext[:, 2])
    scene_ext = np.maximum(cmax.max(axis=0) - cmin.min(axis=0), 1e-30)
    scene_sa = 2.0 * (scene_ext[0] * scene_ext[1] + scene_ext[1] * scene_ext[2]
                      + scene_ext[0] * scene_ext[2])
    live = fill > 0
    return {
        "structure": "cluster",
        "clusters": int(cs.num_clusters),
        "cluster_size": int(cs.cluster_size),
        "faces": int((face_order >= 0).sum()),
        "fill": _hist_summary(fill[live]),
        "rel_surface_area_pct": round(float(sa[live].sum() / scene_sa) * 100,
                                      1),
    }


def grid_stats(grid: HashGrid) -> dict:
    """Bucket occupancy: faces per live bucket (the reference prints each
    cell's face count and warns on full cells, `Hash.cu:223-228`)."""
    occ = np.diff(grid.cell_start.cpu().numpy())
    live = occ > 0
    return {
        "structure": "grid",
        "cells": int(grid.num_cells),
        "live_cells": int(live.sum()),
        "entries": int(occ.sum()),
        "faces_per_live_cell": _hist_summary(occ[live]),
        "load_factor_pct": round(float(live.mean()) * 100, 2),
    }


def cluster_traversal_stats(cs: ClusterSet, eye, orient, rays, height: int,
                            width: int, tile_px: int = 16) -> dict:
    """Survivors per tile of the frustum cull on a probe frame: the work
    the tile sweeps run per tile (each survivor is one cluster's sweep)."""
    from ..trace.dense import _cull_frustum, tile_frustum_planes, tile_pixels
    from ..trace.pipeline import rotate_rays

    dev = cs.cmin.device
    dirs = rotate_rays(torch.as_tensor(rays, dtype=torch.float32, device=dev),
                       torch.as_tensor(orient, dtype=torch.float32,
                                       device=dev))
    d_tiles = tile_pixels(dirs, height, width, tile_px)
    planes = tile_frustum_planes(d_tiles, tile_px)
    survive = _cull_frustum(planes, torch.as_tensor(eye, dtype=torch.float32,
                                                    device=dev),
                            cs.cmin, cs.cmax)
    counts = survive.sum(dim=1).cpu().numpy()
    return {
        "structure": "cluster-traversal",
        "tiles": int(counts.shape[0]),
        "clusters": int(cs.num_clusters),
        "survivors_per_tile": _hist_summary(counts),
        "sweep_segments_total": int(counts.sum()),
    }


def accel_stats(accel) -> dict:
    """Dispatch on the structure's type (the one-call introspection
    entry)."""
    if isinstance(accel, Bvh):
        return bvh_stats(accel)
    if isinstance(accel, ClusterSet):
        return cluster_stats(accel)
    if isinstance(accel, HashGrid):
        return grid_stats(accel)
    raise TypeError(f"no stats for {type(accel).__name__}")
