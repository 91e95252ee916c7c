"""Beam (tile-frustum) tracing of pinhole frames, and kernel L
(counterpart of `raytracercuda_tpu/trace/beam.py`).

The rays of one ``tile_px``² pixel tile share the eye, so they span a
convex cone bounded by the tile's four corner rays.  One skip-link walk
per tile replaces a walk per ray, in rounds:

  * the walk: a node survives when its box is not outside any of the
    tile's 5 planes (the 4 side planes and the plane through the eye
    normal to the mean direction; p-vertex test) and its closest point
    lies within ``tile_tmax`` of the eye (``gap² <= tile_tmax²``), where
    ``tile_tmax`` is the tile's largest best t so far.  A surviving leaf
    appends its ``(first, count)`` to the tile's queue of ``queue``
    entries.  The round's walk ends when the queue is full, the cursor
    is -1 or ``4 * ceil(max_iters / 4)`` steps have passed;
  * the test: each ray of the tile against the queued faces, in queue
    order then slot order, the first minimum with a strict ``<``
    (`tri_intersect`'s Möller-Trumbore, the NaN rule, no ``|det|``
    threshold, ``t < t_epsilon`` clipped with ``clip_backward_hits``);
  * rounds repeat until the cursor is -1, so every tile tests the same
    candidates as the JAX package's and the result is exact.

Kernel L (`csrc/bvh.cu`, replacing the XLA rounds of `trace_beam`,
`beam.py:121-290`) runs each round as a walk, one warp a tile (32 node
rows at a time over `traverse.kernel_rows` in walk order), that writes
the tiles' queues to device memory and cuts them into work items of
`BEAM_CHUNK` entries (`split_queue` is its plain statement), then a test
whose blocks take the items in turn and merge each ray's first minimum
with a 64-bit ``atomicMin`` on (ordered t, candidate ordinal)
(`beam_key`, `candidate_ordinal`; `beam_key_t` reads the next round's
``tile_tmax`` back).  Rounds go out in batches, the host waiting once a
batch for their flags.  An epilogue recovers each winner's row and slot
(`ordinal_entry`, `candidate_row_slot`) and re-runs its test.  The tile
planes (`dense.tile_frustum_planes`) are computed here once and handed
to either version, so the kernel and its plain version cull with the
same planes.

`occlusion_beam`, the any-hit beam toward a directional light, is plain
PyTorch only: no path of the JAX package calls it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel.bvh import Bvh, LEAF_PACK
from ..config import BvhConfig, TraceConfig
from ..ops.cuda_build import kernel_fn, raw_stream
from ..types import FLT_MAX, Hit
from ..utils.profiler import count, span
from .dense import tile_frustum_planes, tile_pixels, untile_pixels
from .sweep import _check_cuda, _eps_args, _pick, t_eps_of
from .traverse import kernel_rows, row_mt, slot_hit

#: Kernel launches, counted where the kernel is launched.
launch_counts = {"beam": 0}

#: Queue entries the plain version tests at once (the JAX package's
#: leaf block).
_LEAF_BLOCK = 64

#: Queue entries in one work item of kernel L's test: of `chip_smoke.py`'s
#: sweep on the H100 (PERF.md), 1 and 2 were the fastest.
BEAM_CHUNK = 2

#: Bits of an entry's candidate k in the ordinal: k < LEAF_PACK.
_K_BITS = 6

#: Bytes of queue log kernel L starts with (at least two rounds, at most
#: eight: 11.6 MB at 512² in 16-pixel tiles); a frame that needs more
#: rounds doubles it.
_LOG_BYTES = 16 << 20

#: Pinned host words the kernel's C entry reads each batch's counters
#: into.
_FLAGS = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def walk_steps(max_iters: int) -> int:
    """Steps a beam round may walk: the JAX package checks its bound every
    4 steps."""
    return -(-max_iters // 4) * 4


def _beam_enter(planes, eye, bmin, bmax, tile_tmax):
    """``[T]`` bool: the node box survives the tile's cone (not outside
    any plane, p-vertex test) and lies within ``tile_tmax`` of the eye.
    Every sum is left to right, as kernel L's."""
    pv = torch.where(planes > 0, bmax[:, None, :], bmin[:, None, :])
    q = pv - eye
    d = (planes[..., 0] * q[..., 0] + planes[..., 1] * q[..., 1]
         + planes[..., 2] * q[..., 2])
    outside = (d < 0.0).any(dim=-1)
    gap = torch.clamp(bmin - eye, min=0.0) + torch.clamp(eye - bmax, min=0.0)
    g2 = gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1] + gap[:, 2] * gap[:, 2]
    return ~outside & ~(g2 > tile_tmax * tile_tmax)


def _walk_round(bvh: Bvh, cur, queue: int, steps: int, survives,
                tally=None):
    """One round of the tiles' walks: until each tile's queue is full or
    its walk ended, at most ``steps`` steps.  ``survives(bmin, bmax)``
    gives ``[T]`` bool.  Returns ``(cur, q_first, q_count, q_n)``; with a
    ``tally`` dict, adds the node tests to its ``box_tests``."""
    num_tiles = cur.shape[0]
    dev = cur.device
    q_first = torch.zeros((num_tiles, queue), dtype=torch.int64, device=dev)
    q_count = torch.zeros((num_tiles, queue), dtype=torch.int64, device=dev)
    q_n = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    rows = torch.arange(num_tiles, device=dev)
    for step in range(steps):
        walking = (cur >= 0) & (q_n < queue)
        if step % 4 == 0 and not bool(walking.any()):
            break
        if tally is not None:
            tally["box_tests"] += int(walking.sum())
        nid = cur.clamp(min=0)
        row = bvh.packed_nodes[nid]
        links = bvh.packed_links[nid].long()
        a, skip = links[:, 0], links[:, 1]
        enter = walking & survives(row[:, 0:3], row[:, 3:6])
        leaf = a < 0
        enc = -a - 2
        append = enter & leaf
        slot_idx = q_n.clamp(max=queue - 1)
        q_first[rows, slot_idx] = torch.where(append, enc // LEAF_PACK,
                                              q_first[rows, slot_idx])
        q_count[rows, slot_idx] = torch.where(append, enc % LEAF_PACK,
                                              q_count[rows, slot_idx])
        q_n = q_n + append.long()
        cur = torch.where(walking, torch.where(enter & ~leaf, a, skip), cur)
    return cur, q_first, q_count, q_n


def split_queue(q_n, chunk: int):
    """Cut each tile's round queue of ``q_n[t]`` entries into work items of
    at most ``chunk`` consecutive entries: ``[3, M]`` int64 rows (tile,
    first entry, end entry), tiles in order and each tile's items in
    queue order.  Kernel L's walk writes the same items, each tile's in
    this order, at places an ``atomicAdd`` gives."""
    dev = q_n.device
    per_tile = (q_n.long() + chunk - 1) // chunk
    tile = torch.repeat_interleave(torch.arange(q_n.numel(), device=dev),
                                   per_tile)
    start = torch.cumsum(per_tile, 0) - per_tile
    lo = (torch.arange(tile.numel(), device=dev) - start[tile]) * chunk
    return torch.stack([tile, lo, torch.minimum(lo + chunk,
                                                q_n.long()[tile])])


def candidate_ordinal(round_, entry, k, queue: int):
    """Kernel L's ordinal of candidate ``k`` of queue entry ``entry`` of
    round ``round_``: ``(round_ * queue + entry) * 64 + k``, rising along a
    tile's candidate sequence (round, queue order, then k)."""
    return ((round_ * queue + entry) << _K_BITS) | k


def ordinal_entry(ordinal, queue: int):
    """``(round, entry, k)`` of an ordinal (`candidate_ordinal`)."""
    return (ordinal >> _K_BITS) // queue, (ordinal >> _K_BITS) % queue, \
        ordinal & (LEAF_PACK - 1)


def candidate_row_slot(first, k, num_slots: int):
    """The triangle row candidate ``k`` of a queue entry tests, ``max(first,
    0) + k``, and the slot it records, ``clip(first + k)``: the two differ
    only for the ``first = -1`` of a Karras leaf that the collapse left
    internal, as in the JAX package."""
    return first.clamp(min=0) + k, torch.clamp(first + k, 0, num_slots - 1)


def beam_key(t, ordinal):
    """Kernel L's 64-bit hit key (`csrc/hit_key.cuh`) of float32 ``t`` and
    ``ordinal``, as int64 whose signed order is the key's unsigned order:
    t's bits mapped to an order monotone over every non-NaN float (-0.0
    as +0.0) in the high word, the ordinal in the low.  The smallest key
    is the first minimum of the candidates in ordinal order."""
    b = t.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)
    ordered = torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b ^ 0x80000000)
    return ((ordered - 0x80000000) << 32) | ordinal.long()


def beam_key_t(key):
    """The float32 t in the high word of `beam_key`'s keys: kernel L's walk
    reads each tile's ``tile_tmax`` back from its rays' largest key
    (-0.0 comes back as +0.0, which squares alike)."""
    ordered = (key >> 32) + 0x80000000
    b = torch.where(ordered >= 0x80000000, ordered ^ 0x80000000,
                    ordered ^ 0xFFFFFFFF)
    return b.to(torch.int32).view(torch.float32)


def _queue_blocks(bvh: Bvh, q_first, q_count, q_n, k_leaf: int):
    """The queued candidates of tiles ``[C]``, ``_LEAF_BLOCK`` queue
    entries at a time: yields ``(slots [C, B*k_leaf], valid, tri [C,
    B*k_leaf, 9])`` in queue order, then slot order.  As in the JAX
    package, candidate ``k`` of an entry tests row ``max(first, 0) + k``
    and records slot ``clip(first + k)``: the two differ only for the
    ``first = -1`` of a Karras leaf that the collapse left internal."""
    num_slots = bvh.packed_tris.shape[0]
    queue = q_first.shape[1]
    dev = q_first.device
    k_off = torch.arange(k_leaf, device=dev)
    b_ids = torch.arange(_LEAF_BLOCK, device=dev)
    n_tiles = q_first.shape[0]
    for q_lo in range(0, int(q_n.max()), _LEAF_BLOCK):
        q_idx = torch.clamp(q_lo + b_ids, max=queue - 1)
        qf = q_first[:, q_idx]
        qc = q_count[:, q_idx]
        valid = (((q_lo + b_ids)[None, :, None] < q_n[:, None, None])
                 & (k_off[None, None, :] < qc[:, :, None]))
        rows, slots = candidate_row_slot(qf[:, :, None], k_off, num_slots)
        yield (slots.reshape(n_tiles, -1), valid.reshape(n_tiles, -1),
               bvh.packed_tris[rows.reshape(n_tiles, -1)])


def _beam_plain(bvh: Bvh, eye, dirs, planes, height: int, width: int,
                tile_px: int, queue: int, k_leaf: int, steps: int, t_eps,
                tiles_per_chunk: int, tally=None):
    """Plain version of kernel L: ``(t, u, v, slot)`` ``[H*W]`` row-major
    for row-major ``dirs [H*W, 3]``; tiles walk in lockstep, and test
    ``tiles_per_chunk`` tiles at a time.  With a ``tally`` dict, adds the
    tiles' node tests and the ray-triangle tests to its ``box_tests`` and
    ``tri_tests``."""
    d_tiles = tile_pixels(dirs, height, width, tile_px)
    num_tiles, rays = d_tiles.shape[0], d_tiles.shape[1]
    dev = dirs.device
    bt = torch.full((num_tiles, rays), float(FLT_MAX), device=dev)
    bu = torch.zeros((num_tiles, rays), device=dev)
    bv = torch.zeros((num_tiles, rays), device=dev)
    bslot = torch.zeros((num_tiles, rays), dtype=torch.int64, device=dev)
    cur = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    while bool((cur >= 0).any()):
        tile_tmax = bt.amax(dim=1)
        cur, q_first, q_count, q_n = _walk_round(
            bvh, cur, queue, steps,
            lambda bmin, bmax: _beam_enter(planes, eye, bmin, bmax,
                                           tile_tmax), tally)
        for c0 in range(0, num_tiles, tiles_per_chunk):
            cs = slice(c0, c0 + tiles_per_chunk)
            for slots, valid, tri in _queue_blocks(
                    bvh, q_first[cs], q_count[cs], q_n[cs], k_leaf):
                t, u, v = row_mt(tri[:, None], eye, d_tiles[cs, :, None],
                                 t_eps)
                t = torch.where(valid[:, None, :], t, float(FLT_MAX))
                if tally is not None:
                    tally["tri_tests"] += int(valid.sum()) * rays
                ct, j = t.min(dim=-1)  # the first minimum, [C, R]
                closer = ct < bt[cs]
                jj = j[..., None]
                bt[cs] = torch.where(closer, ct, bt[cs])
                bu[cs] = torch.where(closer, u.gather(2, jj)[..., 0], bu[cs])
                bv[cs] = torch.where(closer, v.gather(2, jj)[..., 0], bv[cs])
                bslot[cs] = torch.where(closer, slots.gather(1, j), bslot[cs])
    return (untile_pixels(bt, height, width, tile_px),
            untile_pixels(bu, height, width, tile_px),
            untile_pixels(bv, height, width, tile_px),
            untile_pixels(bslot, height, width, tile_px).to(torch.int32))


def _beam_cuda(bvh: Bvh, eye, dirs, planes, height: int, width: int,
               tile_px: int, queue: int, k_leaf: int, steps: int, t_eps,
               tiles_per_chunk: int, stats: dict | None = None):
    """Launch kernel L; outputs as in `_beam_plain`.  The kernel tests
    every tile at once (``tiles_per_chunk`` bounds only the plain
    version's temporaries).  A ``stats`` dict receives the rounds the
    frame needed, the rounds launched (a batch may end past the last) and
    the host syncs, and the scratch: ``log`` (each round's queues and
    items, `round_views`), ``keys`` and ``item_cap``."""
    global _FLAGS
    del tiles_per_chunk
    dev = dirs.device
    num_rays = height * width
    num_tiles = (height // tile_px) * (width // tile_px)
    num_nodes = bvh.packed_nodes.shape[0]
    num_slots = bvh.packed_tris.shape[0]
    if tile_px * tile_px > 1024:
        raise ValueError(f"kernel L takes tiles of at most 1024 pixels, "
                         f"got {tile_px}x{tile_px}")
    _check_cuda("eye", eye, dev, torch.float32, (3,))
    _check_cuda("dirs", dirs, dev, torch.float32, (num_rays, 3))
    _check_cuda("planes", planes, dev, torch.float32, (num_tiles, 5, 3))
    _check_cuda("packed_nodes", bvh.packed_nodes, dev, torch.float32,
                (num_nodes, 6))
    _check_cuda("packed_links", bvh.packed_links, dev, torch.int32,
                (num_nodes, 2))
    _check_cuda("packed_tris", bvh.packed_tris, dev, torch.float32,
                (num_slots, 9))
    node_rows, tri_rows = kernel_rows(bvh)
    item_cap = num_tiles * -(-queue // BEAM_CHUNK)
    keys = torch.empty(num_rays, dtype=torch.int64, device=dev)
    cursor = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    out = torch.empty((3, num_rays), dtype=torch.float32, device=dev)
    slot = torch.empty(num_rays, dtype=torch.int32, device=dev)
    info = (ctypes.c_int * 4)()
    stride = 2 * num_tiles * queue + num_tiles + 3 * item_cap
    begin, end = 0, min(8, max(2, _LOG_BYTES // (4 * stride)))
    log = torch.empty((end, stride), dtype=torch.int32, device=dev)
    syncs = 0
    while True:
        if end * queue > 1 << (32 - _K_BITS):
            raise ValueError(f"kernel L: {end} rounds of {queue} entries "
                             f"overflow the 32-bit candidate ordinal")
        counters = torch.zeros(2 * end, dtype=torch.int32, device=dev)
        if _FLAGS is None or _FLAGS.numel() < 2 * end:
            _FLAGS = torch.zeros(2 * end, dtype=torch.int32,
                                 pin_memory=True)
        # The call waits for the device ``info[2]`` times, once a batch.
        with span("sync.beam"):
            err = kernel_fn("rt_beam")(
                node_rows.data_ptr(), num_nodes, tri_rows.data_ptr(),
                num_slots, eye.data_ptr(), dirs.data_ptr(),
                planes.data_ptr(), height, width, tile_px, queue, k_leaf,
                steps, BEAM_CHUNK, *_eps_args(t_eps), keys.data_ptr(),
                cursor.data_ptr(), log.data_ptr(), counters.data_ptr(),
                _FLAGS.data_ptr(), begin, end, ctypes.addressof(info),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                slot.data_ptr(), raw_stream(dev))
        if err:
            raise RuntimeError(f"kernel L launch failed: CUDA error {err}")
        syncs += info[2]
        count("host_syncs", info[2])
        if not info[1]:
            break
        # More rounds: keep the earlier rounds' queues (the epilogue reads
        # the winners' entries) and go on where the last call stopped.
        begin, end = end, 2 * end
        log = torch.cat([log, torch.empty_like(log)])
    launch_counts["beam"] += 1
    if stats is not None:
        stats.update(rounds=info[0], launched=info[3], syncs=syncs,
                     log=log[:info[0]], keys=keys, item_cap=item_cap)
    return out[0], out[1], out[2], slot


def round_views(log_round, num_tiles: int, queue: int, item_cap: int):
    """One round's block of kernel L's log as ``(q_first [T, queue],
    q_count [T, queue], q_n [T], items [3, item_cap])`` views."""
    tq = num_tiles * queue
    return (log_round[:tq].view(num_tiles, queue),
            log_round[tq:2 * tq].view(num_tiles, queue),
            log_round[2 * tq:2 * tq + num_tiles],
            log_round[2 * tq + num_tiles:].view(3, item_cap))


def trace_beam(
    bvh: Bvh,
    eye: torch.Tensor,
    dirs: torch.Tensor,
    height: int | None = None,
    width: int | None = None,
    tile_px: int = 16,
    queue: int = 256,
    cfg: BvhConfig = BvhConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
    tiles_per_chunk: int = 16,
) -> Hit:
    """Closest hit for a pinhole frame by tile-beam traversal.

    Args:
      eye: ``[3]`` common ray origin.
      dirs: ``[H*W, 3]`` row-major pixel directions (already oriented).
      height/width: frame dims; inferred square if omitted.

    Span ``bvh.L``; kernel L's waits for the device are ``sync.beam``
    spans, counted under ``host_syncs``.
    """
    with span("bvh.L"):
        num_rays = dirs.shape[0]
        if height is None or width is None:
            side = int(round(num_rays ** 0.5))
            if side * side != num_rays:
                raise ValueError("a frame that is not square needs height and "
                                 "width")
            height = width = side
        if height % tile_px or width % tile_px:
            raise ValueError(f"{height}x{width} not divisible by tile "
                             f"{tile_px}")
        dirs = dirs.to(torch.float32).contiguous()
        eye = eye.to(torch.float32).reshape(3).contiguous()
        planes = tile_frustum_planes(
            tile_pixels(dirs, height, width, tile_px), tile_px).contiguous()
        run = _pick(dirs, _beam_plain, _beam_cuda)
        t, u, v, slot = run(bvh, eye, dirs, planes, height, width, tile_px,
                            queue, cfg.max_leaf_faces,
                            walk_steps(cfg.max_iters), t_eps_of(trace_cfg),
                            tiles_per_chunk)
        return slot_hit(bvh, t, u, v, slot)


def occlusion_beam(
    bvh: Bvh,
    origins: torch.Tensor,
    light_dir: torch.Tensor,
    active: torch.Tensor,
    height: int,
    width: int,
    tile_px: int = 16,
    queue: int = 128,
    cfg: BvhConfig = BvhConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
    tiles_per_chunk: int = 32,
) -> torch.Tensor:
    """Beam-culled shadow (any-hit) query toward a directional light.

    A tile's shadow origins lie on the surfaces its primary rays hit, and
    its rays share one direction: the tile's beam is its active origins'
    box swept along ``light_dir``, and a node is culled when it cannot
    occlude the beam (`occlusion_cull.beam_cannot_occlude`).

    Args:
      origins: ``[H*W, 3]`` shadow-ray origins (row-major pixels).
      light_dir: ``[3]`` unit direction toward the light.
      active: ``[H*W]`` bool, the rays that need occlusion.
    Returns:
      ``[H*W]`` bool occlusion mask (False wherever ``active`` is False).
    """
    from .occlusion_cull import beam_cannot_occlude, swept_tile_beams

    if height % tile_px or width % tile_px:
        raise ValueError(f"{height}x{width} not divisible by tile {tile_px}")
    o_tiles = tile_pixels(origins.to(torch.float32), height, width, tile_px)
    a_tiles = tile_pixels(active, height, width, tile_px)
    beam = swept_tile_beams(o_tiles, a_tiles, light_dir.to(torch.float32))
    t_eps = np.float32(trace_cfg.t_epsilon)
    num_tiles = o_tiles.shape[0]
    occ = torch.zeros(a_tiles.shape, dtype=torch.bool, device=origins.device)
    cur = torch.where(beam.tile_any, 0, -1).long()
    steps = walk_steps(cfg.max_iters)
    while bool((cur >= 0).any()):
        cur, q_first, q_count, q_n = _walk_round(
            bvh, cur, queue, steps,
            lambda bmin, bmax: ~beam_cannot_occlude(beam, bmin, bmax))
        for c0 in range(0, num_tiles, tiles_per_chunk):
            cs = slice(c0, c0 + tiles_per_chunk)
            for _, valid, tri in _queue_blocks(
                    bvh, q_first[cs], q_count[cs], q_n[cs],
                    cfg.max_leaf_faces):
                t, _, _ = row_mt(tri[:, None], o_tiles[cs, :, None],
                                 beam.l, None)
                hit = valid[:, None, :] & (t > t_eps) & (t < float(FLT_MAX))
                occ[cs] |= a_tiles[cs] & hit.any(dim=-1)
    return untile_pixels(occ, height, width, tile_px) & active
