"""Primitive-sharded ring traversal, for scenes larger than one card's
memory (counterpart of `raytracercuda_tpu/parallel/ring.py`).

Everywhere else the scene is replicated and the rays are sharded
(`parallel/shard.py`).  Here the primitives are sharded too: on a ring of
``n`` ranks, rank ``i`` keeps ray band ``i`` and starts with cluster shard
``i`` (contiguous clusters of the Morton-ordered `ClusterSet`, about
``1/n`` of the scene).  On each of ``n`` steps it traces its band against
the shard it holds (`bounce_sweep.trace_rays`: the general cull, then C's
epilogue over F's sweep), combines the result into its best hit, and
passes the shard to rank ``i + 1`` while it receives one from ``i - 1``
(`torch.distributed.batch_isend_irecv`).  After ``n`` steps every band has
met every cluster once, and no rank held more than two shards.

Ties come out as on one card: within a shard the sweep takes the lowest
slot among equal t, and across shards `_combine` takes the lower global
shard on an exact t tie.  Shards are contiguous slot ranges, so that is
the replicated sweep's rule, in whatever order the shards arrive.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..accel.clusters import ClusterSet
from ..config import TraceConfig
from ..types import FLT_MAX, Hit
from .mesh import all_gather_rays, make_ray_mesh, ray_sharding

RING_AXIS = "ring"

#: The far point box of a padding cluster: every ray's slab test rejects
#: it (+-inf boxes would survive every cull).
_FAR = 3.0e37


def make_ring_mesh(num_devices: int | None = None):
    """A 1-D `DeviceMesh` over the process group, axis ``"ring"``."""
    return make_ray_mesh(num_devices, axis=RING_AXIS)


def pad_clusters_for_ring(cs: ClusterSet, n: int) -> ClusterSet:
    """Pad the cluster count to a multiple of ``n`` with clusters that miss
    every ray: a far point box (``cmin == cmax == 3e37``, which the cull
    rejects), zero triangles and ``-1`` face ids.  ``face_rank`` stays as
    it is."""
    C, L = cs.num_clusters, cs.cluster_size
    rem = (-C) % n
    if rem == 0:
        return cs

    def pad(x, fill):
        tail = x.new_full((rem,) + tuple(x.shape[1:]), fill)
        return torch.cat([x, tail])

    return cs._replace(
        cmin=pad(cs.cmin, _FAR), cmax=pad(cs.cmax, _FAR),
        tris=pad(cs.tris, 0.0),
        face_order=torch.cat([cs.face_order,
                              cs.face_order.new_full((rem * L,), -1)]),
        tri_blocks=None if cs.tri_blocks is None else pad(cs.tri_blocks, 0.0))


def _combine(a: Hit, a_src: torch.Tensor, b: Hit, b_src: torch.Tensor):
    """Closest of two hits on disjoint triangle sets: a strict ``<``, and
    an exact t tie to the lower global shard."""
    tie = (b.t == a.t) & (b.face >= 0) & (b_src < a_src)
    closer = (b.t < a.t) | tie
    return Hit(*(torch.where(closer, y, x) for x, y in zip(a, b))), \
        torch.where(closer, b_src, a_src)


def _shard(cs: ClusterSet, i: int, n: int) -> list[torch.Tensor]:
    """Cluster shard ``i`` of ``n`` as the tensors that travel the ring:
    boxes, geometry rows and face ids."""
    from ..trace.sweep import segment_blocks

    c = cs.num_clusters // n
    L = cs.cluster_size
    lo, hi = i * c, (i + 1) * c
    return [cs.cmin[lo:hi].contiguous(), cs.cmax[lo:hi].contiguous(),
            segment_blocks(cs)[lo:hi].contiguous(),
            cs.face_order[lo * L:hi * L].contiguous()]


def trace_ring_sharded(cs: ClusterSet, origin: torch.Tensor,
                       dirs: torch.Tensor, mesh,
                       trace_cfg: TraceConfig = TraceConfig(),
                       active: torch.Tensor | None = None) -> Hit:
    """Closest hit with the primitives sharded over the ring.

    ``origin`` and ``dirs`` are ``[R, 3]`` ray bundles that every rank
    holds; the mesh size must divide ``R`` (`pad_rays_for_mesh`) and the
    cluster count (`pad_clusters_for_ring`).  Returns on every rank the
    `Hit` of `bounce_sweep.trace_rays` on the whole cluster set, bit for
    bit."""
    from ..trace.bounce_sweep import trace_rays

    n = mesh.size()
    if cs.num_clusters % n:
        raise ValueError(
            f"cluster count {cs.num_clusters} not divisible by mesh size "
            f"{n}; call pad_clusters_for_ring first")
    if origin.shape[0] % n:
        raise ValueError(
            f"ray count {origin.shape[0]} not divisible by mesh size {n}; "
            f"call pad_rays_for_mesh first")
    if active is None:
        active = torch.ones(origin.shape[:1], dtype=torch.bool,
                            device=origin.device)
    me = mesh.get_local_rank()
    o, d, act = (ray_sharding(mesh, x) for x in (origin, dirs, active))
    r = o.shape[0]
    best = Hit(t=torch.full((r,), float(FLT_MAX), device=o.device),
               u=torch.zeros(r, device=o.device),
               v=torch.zeros(r, device=o.device),
               face=torch.full((r,), -1, dtype=torch.int32, device=o.device))
    best_src = torch.full((r,), n, dtype=torch.int32, device=o.device)
    held = _shard(cs, me, n)
    group = mesh.get_group()
    ranks = dist.get_process_group_ranks(group) if n > 1 else None
    for k in range(n):
        # Rank i receives from i - 1, so at step k it holds shard i - k.
        if k + 1 < n:
            incoming = [torch.empty_like(x) for x in held]
            ops = [dist.P2POp(dist.isend, x, ranks[(me + 1) % n], group)
                   for x in held]
            ops += [dist.P2POp(dist.irecv, x, ranks[(me - 1) % n], group)
                    for x in incoming]
            reqs = dist.batch_isend_irecv(ops)
        cmin, cmax, blocks, face_order = held
        shard = ClusterSet(cmin=cmin, cmax=cmax, tris=None,
                           face_order=face_order, tri_blocks=blocks)
        h = trace_rays(shard, blocks, o, d, trace_cfg=trace_cfg, active=act)
        src = torch.full((r,), (me - k) % n, dtype=torch.int32,
                         device=o.device)
        best, best_src = _combine(best, best_src, h, src)
        if k + 1 < n:
            for req in reqs:
                req.wait()
            held = incoming
    return Hit(*(all_gather_rays(mesh, x) for x in best))


def any_hit_ring_sharded(cs: ClusterSet, origin: torch.Tensor,
                         dirs: torch.Tensor, max_t: torch.Tensor, mesh,
                         trace_cfg: TraceConfig = TraceConfig(),
                         **kw) -> torch.Tensor:
    """Occlusion over the primitive-sharded scene: ``[R]`` bool, a hit
    closer than ``max_t``."""
    hit = trace_ring_sharded(cs, origin, dirs, mesh, trace_cfg, **kw)
    return hit.hit_mask & (hit.t < max_t)
