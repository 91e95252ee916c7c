"""Wavefront (queue-based) BVH traversal (counterpart of
`raytracercuda_tpu/trace/wavefront.py`), plain PyTorch.

The reference's unfinished streaming path (`Raytracer/Trace2.cu`), in
rounds:

  * expand: every ray walks the skip-link BVH until it has queued
    ``max_hits_per_ray`` leaves or finished the tree;
  * test: all queued (ray, leaf face) pairs in one ``[R, Q*K]`` batch of
    `tri_intersect`, the first minimum in queue order with a strict ``<``
    against the best so far;
  * the best t then prunes the next round's walk (``box_d < best_t``).

A ray whose queue fills resumes its walk in the next round, so the result
is the exact closest hit.  Rays go in blocks of ``ray_chunk``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel.bvh import Bvh
from ..config import BvhConfig, TraceConfig, WavefrontConfig
from ..ops.math import box_ray_intersect, tri_intersect
from ..types import FLT_MAX, Hit


def trace_wavefront(
    bvh: Bvh,
    positions: torch.Tensor,
    faces: torch.Tensor,
    origin: torch.Tensor,
    direction: torch.Tensor,
    cfg: BvhConfig = BvhConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
    wf_cfg: WavefrontConfig = WavefrontConfig(),
) -> Hit:
    """Closest hit of ``[R, 3]`` rays by round-based wavefront traversal,
    ``wf_cfg.ray_chunk`` rays at a time; ``origin`` is ``[R, 3]`` or
    ``[3]``."""
    direction = direction.to(torch.float32)
    origin = origin.to(torch.float32).expand(direction.shape)
    num_rays = direction.shape[0]
    chunk = max(1, min(wf_cfg.ray_chunk, num_rays))
    hits = [_trace_wavefront_chunk(bvh, positions, faces,
                                   origin[r0:r0 + chunk],
                                   direction[r0:r0 + chunk], cfg, trace_cfg,
                                   wf_cfg)
            for r0 in range(0, num_rays, chunk)]
    return Hit(*(torch.cat(x) for x in zip(*hits)))


def _trace_wavefront_chunk(bvh: Bvh, positions, faces, origin, direction,
                           cfg: BvhConfig, trace_cfg: TraceConfig,
                           wf_cfg: WavefrontConfig) -> Hit:
    num_rays = direction.shape[0]
    dev = direction.device
    inv_dir = 1.0 / direction
    t_eps = np.float32(trace_cfg.t_epsilon)
    q_cap = wf_cfg.max_hits_per_ray
    num_faces = bvh.face_order.shape[0]
    rows = torch.arange(num_rays, device=dev)
    cur = torch.zeros(num_rays, dtype=torch.int64, device=dev)
    bt = torch.full((num_rays,), float(FLT_MAX), device=dev)
    bu = torch.zeros(num_rays, device=dev)
    bv = torch.zeros(num_rays, device=dev)
    bf = torch.full((num_rays,), -1, dtype=torch.int64, device=dev)
    k_ids = torch.arange(cfg.max_leaf_faces, device=dev)
    q_ids = torch.arange(q_cap, device=dev)
    f = faces.long()

    for _ in range(cfg.max_iters):
        if not bool((cur >= 0).any()):
            break
        # Expand: walk until the queues fill.
        queue = torch.zeros((num_rays, q_cap), dtype=torch.int64, device=dev)
        qcount = torch.zeros(num_rays, dtype=torch.int64, device=dev)
        for _ in range(cfg.max_iters):
            walking = (cur >= 0) & (qcount < q_cap)
            if not bool(walking.any()):
                break
            nid = cur.clamp(min=0)
            box_d = box_ray_intersect(bvh.node_min[nid], bvh.node_max[nid],
                                      origin, inv_dir)
            enter = walking & (box_d < bt)
            leaf = bvh.is_leaf[nid]
            append = enter & leaf
            slot = qcount.clamp(max=q_cap - 1)
            queue[rows, slot] = torch.where(append, nid, queue[rows, slot])
            qcount = qcount + append.long()
            nxt = torch.where(enter & ~leaf, bvh.hit_link[nid],
                              bvh.skip_link[nid])
            cur = torch.where(walking, nxt, cur)

        # Test every queued (leaf, face) pair, then reduce.
        q_valid = q_ids[None, :] < qcount[:, None]  # [R, Q]
        qnode = torch.where(q_valid, queue, 0)
        lfirst = bvh.leaf_first[qnode]
        lcount = bvh.leaf_count[qnode]
        in_range = q_valid[:, :, None] & (k_ids < lcount[:, :, None])
        slots = torch.clamp(lfirst[:, :, None] + k_ids, 0, num_faces - 1)
        fid = bvh.face_order[slots.reshape(num_rays, -1)]  # [R, Q*K]
        frow = f[fid]
        t, u, v = tri_intersect(origin[:, None, :], direction[:, None, :],
                                positions[frow[..., 0]],
                                positions[frow[..., 1]],
                                positions[frow[..., 2]])
        if trace_cfg.clip_backward_hits:
            t = torch.where(t < t_eps, float(FLT_MAX), t)
        t = torch.where(in_range.reshape(num_rays, -1), t, float(FLT_MAX))
        ct, j = t.min(dim=1)  # the first minimum
        jj = j[:, None]
        closer = ct < bt
        bt = torch.where(closer, ct, bt)
        bu = torch.where(closer, u.gather(1, jj)[:, 0], bu)
        bv = torch.where(closer, v.gather(1, jj)[:, 0], bv)
        bf = torch.where(closer, fid.gather(1, jj)[:, 0], bf)

    bf = torch.where(bt == float(FLT_MAX), -1, bf)
    return Hit(t=bt, u=bu, v=bv, face=bf.to(torch.int32))
