"""Stackless skip-link BVH traversal, one walk per ray, and kernel K
(counterpart of `raytracercuda_tpu/trace/traverse.py`).

Each ray carries one integer, its current node in the threaded LBVH
(`accel/bvh.py`): test the node's box, go to the hit link of an internal
node it enters, test a leaf's Morton-sorted triangles and go on to the
skip link.  The rules that decide the results are the JAX package's:

  * the walk starts at node 0 and ends at -1, or after ``max_iters``
    steps of that ray;
  * a leaf's a-link ``a < 0`` encodes ``enc = -a - 2``, ``first = enc //
    LEAF_PACK`` and ``count = enc % LEAF_PACK`` with floor division, and
    its slots ``first + k`` are clipped to the table.  A Karras leaf that
    the collapse left internal (all of them when ``max_leaf_faces`` is at
    least the face count plus one) has ``a = -1``: ``first = -1`` and
    ``count = 63``, so the walk tests slots 0 to 61, slot 0 twice;
  * ``inv_dir = 1 / d`` and the slab test of `ops/math.box_ray_intersect`;
    a closest-hit walk enters a box when its entry distance is below the
    best t, an any-hit walk when it is below the ray's ``t_max``;
  * a leaf's faces are tested in ascending slot with the oracle's
    Möller-Trumbore (`ops/math.tri_intersect`: the NaN miss rule, no
    ``|det|`` threshold); with ``clip_backward_hits`` a closest hit below
    ``t_epsilon`` becomes FLT_MAX, and a hit replaces the best only on a
    strict ``<``, so the result is the first minimum in slot order;
  * an any-hit ray is occluded by a face with ``t_eps < t < t_max`` and
    stops there.

Kernel K (`csrc/bvh.cu:walk_kernel`, replacing the XLA loops
`_closest_hit_tile` and `_any_hit_tile`, `traverse.py:62-124,163-209`)
runs one thread per ray over `kernel_rows`, the kernels' copy of the
tree: a node's box and both links in one 32-byte row, the rows in
`walk_order`, a triangle as v0 | e1 | e2 in one 48-byte row.
`trace_bvh` and `any_hit_bvh` run the plain PyTorch version for tensors
on the CPU and launch kernel K for tensors on a GPU; there is no
fallback from one to the other.  The plain version
walks all live rays in lockstep, one host round-trip a step.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..accel.bvh import Bvh, LEAF_PACK
from ..config import BvhConfig, TraceConfig
from ..ops.cuda_build import kernel_fn, raw_stream
from ..ops.math import box_ray_intersect
from ..types import FLT_MAX, Hit
from ..utils.profiler import span
from .bruteforce import _mt_oracle
from .sweep import _check_cuda, _eps_args, _pick, t_eps_of

#: Kernel launches, counted where the kernel is launched.
launch_counts = {"walk_closest": 0, "walk_any": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _leaf_width(bvh: Bvh) -> int:
    """The largest face count a leaf's a-link encodes (at least 1)."""
    a = bvh.packed_links[:, 0].long()
    return max(1, int(torch.where(a < 0, (-a - 2) % LEAF_PACK, 0).max()))


def row_mt(tri, o, d, t_eps):
    """Möller-Trumbore of rays ``o``, ``d`` (``[..., 3]``) against
    `Bvh.packed_tris` rows ``tri`` (``[..., 9]``, v0|v1|v2), all
    broadcast: t/u/v.  The edges are formed here, as kernels K and L form
    them, and the terms are `tri_intersect`'s, each sum left to right
    (`bruteforce._mt_oracle`)."""
    v0 = tri[..., 0:3]
    e1 = tri[..., 3:6] - v0
    e2 = tri[..., 6:9] - v0
    cols = (v0[..., 0], v0[..., 1], v0[..., 2], e1[..., 0], e1[..., 1],
            e1[..., 2], e2[..., 0], e2[..., 1], e2[..., 2])
    return _mt_oracle(cols, o[..., 0], o[..., 1], o[..., 2], d[..., 0],
                      d[..., 1], d[..., 2], t_eps)


def leaf_test(bvh: Bvh, first, count, width: int, o, d, t_eps):
    """`row_mt` of ``[L]`` rays against their leaf's slots ``first + k``,
    ``k < count``, over ``width`` columns: t/u/v ``[L, width]`` (FLT_MAX
    where ``k >= count``) and the slots."""
    num_slots = bvh.packed_tris.shape[0]
    k = torch.arange(width, device=first.device)
    slots = torch.clamp(first[:, None] + k, 0, num_slots - 1)
    t, u, v = row_mt(bvh.packed_tris[slots], o[:, None], d[:, None], t_eps)
    t = torch.where(k < count[:, None], t, float(FLT_MAX))
    return t, u, v, slots


#: The kernels' copies of each live structure's tree: ``{id(packed_nodes):
#: (weak references to packed_nodes, packed_links and packed_tris, their
#: versions, (node_rows, tri_rows))}``; an entry leaves with its tree.
_KERNEL_ROWS: dict = {}


def walk_order(links: torch.Tensor) -> torch.Tensor | None:
    """``[N]`` int64, each node's row in the kernels' node table: the nodes
    reachable from the root in the order a walk that enters every box
    visits them (pre-order), then the others in index order.  In it an
    internal node's hit link and a leaf's skip link are the next row, and
    every skip link passes over exactly the node's subtree.  None where the
    links do not form such a threaded tree."""
    a = links[:, 0].long().cpu()
    skip = links[:, 1].long().cpu()
    n = a.numel()
    frontier = torch.zeros(1, dtype=torch.int64)
    reached, levels = [frontier], []
    while frontier.numel():
        inner = frontier[a[frontier] >= 0]
        left = a[inner]
        right = skip[left.clamp(max=n - 1)]
        if bool((left >= n).any() | (right < 0).any() | (right >= n).any()) \
                or len(levels) > n:
            return None
        levels.append((inner, left, right))
        frontier = torch.cat([left, right])
        reached.append(frontier)
    reached = torch.cat(reached)
    m = reached.numel()
    size = torch.ones(n, dtype=torch.int64)
    for inner, left, right in reversed(levels):
        size[inner] = 1 + size[left] + size[right]
    rank = torch.full((n,), -1, dtype=torch.int64)
    rank[0] = 0
    for inner, left, right in levels:
        rank[left] = rank[inner] + 1
        rank[right] = rank[inner] + 1 + size[left]
    others = rank < 0
    rank[others] = m + torch.arange(int(others.sum()))
    # Each reached node's skip link must lead to the row after its
    # subtree (-1 after the last).
    sk = skip[reached]
    after = torch.where(sk >= 0, rank[sk.clamp(min=0)], m)
    if not (torch.equal(torch.sort(rank).values, torch.arange(n))
            and torch.equal(after, rank[reached] + size[reached])
            and bool((sk >= -1).all())):
        return None
    return rank.to(links.device)


def kernel_rows(bvh: Bvh) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernels K's and L's copy of ``bvh``'s tree on its device, built once
    per structure (and again if one of its packed tensors is modified in
    place): node rows ``[N, 8]`` int32 in `walk_order`, the box's min |
    max float bits, the a-link and the skip link renumbered to the new
    rows (32 bytes, two 16-byte loads; the root stays row 0, a leaf's
    a-link keeps its face range), and triangle rows ``[S, 12]`` float32,
    v0 | e1 | e2 | three zeros (48 bytes, three 16-byte loads).  e1 = v1 -
    v0 and e2 = v2 - v0 are the single subtractions `row_mt` forms, so a
    kernel's tests round as the plain versions' do.  Raises ValueError
    where the links do not form a threaded tree, as `build_bvh`'s do.
    `Bvh` keeps the JAX package's fields; this copy lives beside it."""
    nodes, links, tris = bvh.packed_nodes, bvh.packed_links, bvh.packed_tris
    stamp = (nodes._version, links._version, tris._version)
    key = id(nodes)
    hit = _KERNEL_ROWS.get(key)
    if (hit is not None and hit[0]() is nodes and hit[1]() is links
            and hit[2]() is tris and hit[3] == stamp):
        return hit[4]
    row_of = walk_order(links)
    if row_of is None:
        raise ValueError("kernels K and L need packed_links that form a "
                         "threaded tree (traverse.walk_order)")
    node_of = torch.empty_like(row_of)
    node_of[row_of] = torch.arange(row_of.numel(), device=row_of.device)
    old = links[node_of].long()
    new = torch.where(old >= 0, row_of[old.clamp(min=0)], old)
    node_rows = torch.cat([nodes[node_of].contiguous().view(torch.int32),
                           new.to(torch.int32)], dim=1).contiguous()
    v0 = tris[:, 0:3]
    tri_rows = torch.cat([v0, tris[:, 3:6] - v0, tris[:, 6:9] - v0,
                          torch.zeros_like(v0)], dim=1).contiguous()
    _KERNEL_ROWS[key] = (
        weakref.ref(nodes, lambda _: _KERNEL_ROWS.pop(key, None)),
        weakref.ref(links), weakref.ref(tris), stamp, (node_rows, tri_rows))
    return node_rows, tri_rows


def _node(bvh: Bvh, cur):
    row = bvh.packed_nodes[cur]
    links = bvh.packed_links[cur].long()
    return row[:, 0:3], row[:, 3:6], links[:, 0], links[:, 1]


def _tally(tally, bvh: Bvh, rays, num_rays: int, nodes=None, first=None,
           tested=None) -> None:
    """Add a step's work to ``tally`` (when given): a slab test of each
    node of ``nodes`` to its ``box_tests``, and ``tested[i]`` ray-triangle
    tests of rows ``first[i] + k`` to its ``tri_tests``.  Its boolean
    ``touched_nodes`` and ``touched_rows`` mark the `Bvh.packed_nodes`
    and `Bvh.packed_tris` rows read at least once, and its ``[num_rays]``
    ``ray_steps`` and ``ray_tri_tests`` count each ray's steps and tests
    (``rays`` are the rays of ``nodes`` or ``first``)."""
    if tally is None:
        return
    dev = bvh.packed_nodes.device
    touched_nodes = tally.setdefault("touched_nodes", torch.zeros(
        bvh.packed_nodes.shape[0], dtype=torch.bool, device=dev))
    touched_rows = tally.setdefault("touched_rows", torch.zeros(
        bvh.packed_tris.shape[0], dtype=torch.bool, device=dev))
    per_ray = {name: tally.setdefault(name, torch.zeros(
        num_rays, dtype=torch.int64, device=dev))
        for name in ("ray_steps", "ray_tri_tests")}
    if nodes is not None:
        tally["box_tests"] += nodes.numel()
        touched_nodes[nodes] = True
        per_ray["ray_steps"][rays] += 1
    if first is not None and first.numel():
        tally["tri_tests"] += int(tested.sum())
        per_ray["ray_tri_tests"][rays] += tested
        k = torch.arange(int(tested.max()), device=dev)
        rows = (first[:, None] + k)[k < tested[:, None]]
        touched_rows[torch.clamp(rows, 0, touched_rows.numel() - 1)] = True


def _walk_closest_plain(bvh: Bvh, origin, direction, max_iters: int, t_eps,
                        tally=None):
    """Plain version of kernel K (closest hit): ``(t, u, v, slot)`` ``[R]``
    for row-major ``[R, 3]`` rays.  Live rays step in lockstep.  With a
    ``tally`` dict, adds the slab tests and ray-triangle tests the walk
    needs, and the rows they read (`_tally`)."""
    num_rays = direction.shape[0]
    dev = direction.device
    inv_dir = 1.0 / direction
    cur = torch.zeros(num_rays, dtype=torch.int64, device=dev)
    bt = torch.full((num_rays,), float(FLT_MAX), device=dev)
    bu = torch.zeros(num_rays, device=dev)
    bv = torch.zeros(num_rays, device=dev)
    bslot = torch.zeros(num_rays, dtype=torch.int32, device=dev)
    width = _leaf_width(bvh)
    for _ in range(max_iters):
        live = torch.nonzero(cur >= 0).squeeze(1)
        if live.numel() == 0:
            break
        nmin, nmax, a, skip = _node(bvh, cur[live])
        o, inv = origin[live], inv_dir[live]
        box_d = box_ray_intersect(nmin, nmax, o, inv)
        enter = box_d < bt[live]
        leaf = a < 0
        at = torch.nonzero(enter & leaf).squeeze(1)
        if at.numel():
            rays = live[at]
            enc = -a[at] - 2
            count = enc % LEAF_PACK
            t, u, v, slots = leaf_test(bvh, enc // LEAF_PACK, count, width,
                                       o[at], direction[rays], t_eps)
            _tally(tally, bvh, rays, num_rays, first=enc // LEAF_PACK,
                   tested=count)
            t_blk, j = t.min(dim=1)  # the first minimum in slot order
            closer = t_blk < bt[rays]
            jj = j[:, None]
            bt[rays] = torch.where(closer, t_blk, bt[rays])
            bu[rays] = torch.where(closer, u.gather(1, jj)[:, 0], bu[rays])
            bv[rays] = torch.where(closer, v.gather(1, jj)[:, 0], bv[rays])
            bslot[rays] = torch.where(closer, slots.gather(1, jj)[:, 0].to(
                torch.int32), bslot[rays])
        _tally(tally, bvh, live, num_rays, nodes=cur[live])
        cur[live] = torch.where(enter & ~leaf, a, skip)
    return bt, bu, bv, bslot


def _walk_any_plain(bvh: Bvh, origin, direction, t_max, max_iters: int,
                    t_eps, tally=None):
    """Plain version of kernel K (any hit): ``[R]`` bool, True where a
    face lies in ``(t_eps, t_max)``.  ``tally`` as `_walk_closest_plain`'s;
    an occluded ray's leaf counts its tests up to the occluder."""
    num_rays = direction.shape[0]
    dev = direction.device
    inv_dir = 1.0 / direction
    cur = torch.zeros(num_rays, dtype=torch.int64, device=dev)
    occluded = torch.zeros(num_rays, dtype=torch.bool, device=dev)
    width = _leaf_width(bvh)
    for _ in range(max_iters):
        live = torch.nonzero(cur >= 0).squeeze(1)
        if live.numel() == 0:
            break
        nmin, nmax, a, skip = _node(bvh, cur[live])
        o, inv = origin[live], inv_dir[live]
        enter = box_ray_intersect(nmin, nmax, o, inv) < t_max[live]
        leaf = a < 0
        at = torch.nonzero(enter & leaf).squeeze(1)
        if at.numel():
            rays = live[at]
            enc = -a[at] - 2
            count = enc % LEAF_PACK
            t, _, _, _ = leaf_test(bvh, enc // LEAF_PACK, count, width,
                                   o[at], direction[rays], None)
            hits = (t > t_eps) & (t < t_max[rays][:, None])
            hit = hits.any(dim=1)
            if tally is not None:
                _tally(tally, bvh, rays, num_rays, first=enc // LEAF_PACK,
                       tested=torch.where(
                           hit, hits.int().argmax(dim=1) + 1, count))
            occluded[rays] |= hit
        _tally(tally, bvh, live, num_rays, nodes=cur[live])
        nxt = torch.where(enter & ~leaf, a, skip)
        cur[live] = torch.where(occluded[live], -1, nxt)
    return occluded


def _walk_cuda(bvh: Bvh, origin, direction, t_max, max_iters: int, t_eps,
               any_hit: bool):
    """Launch kernel K; outputs as in `_walk_closest_plain` (``t_max``
    None) or `_walk_any_plain`."""
    num_rays = direction.shape[0]
    dev = direction.device
    num_nodes = bvh.packed_nodes.shape[0]
    num_slots = bvh.packed_tris.shape[0]
    _check_cuda("origin", origin, dev, torch.float32, (num_rays, 3))
    _check_cuda("direction", direction, dev, torch.float32, (num_rays, 3))
    _check_cuda("packed_nodes", bvh.packed_nodes, dev, torch.float32,
                (num_nodes, 6))
    _check_cuda("packed_links", bvh.packed_links, dev, torch.int32,
                (num_nodes, 2))
    _check_cuda("packed_tris", bvh.packed_tris, dev, torch.float32,
                (num_slots, 9))
    node_rows, tri_rows = kernel_rows(bvh)
    if any_hit:
        _check_cuda("t_max", t_max, dev, torch.float32, (num_rays,))
        occluded = torch.empty(num_rays, dtype=torch.bool, device=dev)
        err = kernel_fn("rt_walk_any")(
            node_rows.data_ptr(), tri_rows.data_ptr(), num_slots,
            origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
            num_rays, max_iters, float(t_eps), occluded.data_ptr(),
            raw_stream(dev))
        if err:
            raise RuntimeError(f"kernel K (any hit) launch failed: CUDA "
                               f"error {err}")
        launch_counts["walk_any"] += 1
        return occluded
    out = torch.empty((3, num_rays), dtype=torch.float32, device=dev)
    slot = torch.empty(num_rays, dtype=torch.int32, device=dev)
    err = kernel_fn("rt_walk_closest")(
        node_rows.data_ptr(), tri_rows.data_ptr(), num_slots,
        origin.data_ptr(), direction.data_ptr(), num_rays, max_iters,
        *_eps_args(t_eps), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), slot.data_ptr(), raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel K (closest hit) launch failed: CUDA "
                           f"error {err}")
    launch_counts["walk_closest"] += 1
    return out[0], out[1], out[2], slot


def _walk_closest_cuda(bvh, origin, direction, max_iters, t_eps):
    return _walk_cuda(bvh, origin, direction, None, max_iters, t_eps, False)


def _walk_any_cuda(bvh, origin, direction, t_max, max_iters, t_eps):
    return _walk_cuda(bvh, origin, direction, t_max, max_iters, t_eps, True)


def _rays(origin, direction):
    direction = direction.to(torch.float32).contiguous()
    origin = origin.to(torch.float32).expand(direction.shape).contiguous()
    return origin, direction


def slot_hit(bvh: Bvh, t, u, v, slot) -> Hit:
    """A `Hit` from a walk's best (t, u, v, slot): the face is
    ``face_order[slot]`` where ``t < FLT_MAX``, else -1."""
    face = torch.where(t == float(FLT_MAX), -1,
                       bvh.face_order[slot.long()].to(torch.int32))
    return Hit(t=t, u=u, v=v, face=face.to(torch.int32))


def trace_bvh(
    bvh: Bvh,
    positions: torch.Tensor,
    faces: torch.Tensor,
    origin: torch.Tensor,
    direction: torch.Tensor,
    cfg: BvhConfig = BvhConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
) -> Hit:
    """Closest hit for ``[R,3]`` rays against the threaded LBVH.
    ``positions``/``faces`` are unused (the geometry is in
    ``bvh.packed_tris``) but kept so all tracer backends share one
    signature; ``origin`` is ``[R,3]`` or ``[3]``.  Span ``bvh.K``."""
    del positions, faces
    with span("bvh.K"):
        origin, direction = _rays(origin, direction)
        run = _pick(direction, _walk_closest_plain, _walk_closest_cuda)
        t, u, v, slot = run(bvh, origin, direction, cfg.max_iters,
                            t_eps_of(trace_cfg))
        return slot_hit(bvh, t, u, v, slot)


def any_hit_bvh(
    bvh: Bvh,
    positions: torch.Tensor,
    faces: torch.Tensor,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_max,
    cfg: BvhConfig = BvhConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
) -> torch.Tensor:
    """Occlusion (shadow-ray) query: True where anything lies in
    ``(t_epsilon, t_max)``; ``t_max`` is ``[R]`` or a scalar.  Span
    ``bvh.K``."""
    del positions, faces
    with span("bvh.K"):
        origin, direction = _rays(origin, direction)
        t_max = torch.as_tensor(t_max, dtype=torch.float32,
                                device=direction.device).expand(
            direction.shape[:1]).contiguous()
        run = _pick(direction, _walk_any_plain, _walk_any_cuda)
        return run(bvh, origin, direction, t_max, cfg.max_iters,
                   np.float32(trace_cfg.t_epsilon))
