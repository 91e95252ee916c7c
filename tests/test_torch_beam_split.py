"""The pieces of kernel L's split design that live in plain PyTorch
(`raytracercuda_torch.trace.beam`: `split_queue`, `candidate_ordinal`,
`ordinal_entry`, `candidate_row_slot`, `beam_key`, `beam_key_t`) and the
kernels' copy of the tree (`traverse.kernel_rows`), on the CPU.

The kernel itself runs only on the card (`chip_smoke.py` phases 33 and
33b hold it against `_beam_plain` there).  Here `split_beam` replays its
design step by step in PyTorch: rounds of the tiles' walks, each round's
queues cut into work items by `split_queue`, each item's first minimum
per ray merged by the smallest `beam_key` on (t, candidate ordinal), the
next round's ``tile_tmax`` read back from the keys, and an epilogue that
recovers each winner's row and slot from its ordinal and re-runs its
test.  It must equal `_beam_plain` exactly (slots equal, t/u/v bitwise)
on every `BEAM_CASES` frame: several rounds, trees without traversal
leaves (``first = -1``) and exact-t ties among them.
"""

import numpy as np
import pytest
import torch

from test_torch_beam import BEAM_CASES
from test_torch_bvh import big_triangles, random_mesh

from raytracercuda_torch.accel.bvh import build_bvh
from raytracercuda_torch.config import BvhConfig
from raytracercuda_torch.models.camera import orient_from_pan_pitch
from raytracercuda_torch.trace import beam, traverse
from raytracercuda_torch.trace.dense import (tile_frustum_planes,
                                             tile_pixels, untile_pixels)
from raytracercuda_torch.types import FLT_MAX

import raytracercuda_tpu.models.camera as jcamera


def window_walk_round(node_rows, cur, queue, steps, enters):
    """One round of kernel L's walk as its warps take it over node rows in
    walk order (`traverse.kernel_rows`): 32 rows from the cursor at a time,
    a row visited when no earlier row of the 32 skips past it, the visited
    rows kept up to the step limit and the full queue.  ``enters(tile,
    bmin, bmax)`` gives ``[32]`` bool.  Returns what `beam._walk_round`
    returns, the cursors as rows."""
    num_tiles, num_rows = cur.numel(), node_rows.shape[0]
    box = node_rows[:, :6].contiguous().view(torch.float32)
    a, skip = node_rows[:, 6].long(), node_rows[:, 7].long()
    q_first = torch.zeros((num_tiles, queue), dtype=torch.int64)
    q_count = torch.zeros((num_tiles, queue), dtype=torch.int64)
    q_n = torch.zeros(num_tiles, dtype=torch.int64)
    cur = cur.clone()
    for tile in range(num_tiles):
        c, n, step = int(cur[tile]), 0, 0
        while c >= 0 and step < steps and n < queue:
            v = c + torch.arange(32)
            valid = v < num_rows
            w = v.clamp(max=num_rows - 1)
            enter = valid & enters(tile, box[w, :3], box[w, 3:])
            leaf = a[w] < 0
            jump = torch.where(valid & (leaf | ~enter),
                               torch.where(skip[w] < 0, 2 ** 31 - 1,
                                           skip[w]), 0)
            before = torch.cat([torch.zeros(1, dtype=torch.int64),
                                torch.cummax(jump, 0).values[:-1]])
            visited = valid & (before <= v)
            append = visited & enter & leaf
            s_v = torch.cumsum(visited, 0) - visited.long()
            n_v = torch.cumsum(append, 0) - append.long()
            kept = visited & (step + s_v < steps) & (n + n_v < queue)
            enc = -a[w] - 2
            at = (kept & append).nonzero()[:, 0]
            q_first[tile, n + n_v[at]] = enc[at] // beam.LEAF_PACK
            q_count[tile, n + n_v[at]] = enc[at] % beam.LEAF_PACK
            last = int(kept.nonzero().max())
            c = int(a[w[last]] if enter[last] and not leaf[last]
                    else skip[w[last]])
            step += int(kept.sum())
            n += int((append & kept).sum())
        cur[tile], q_n[tile] = c, n
    return cur, q_first, q_count, q_n


def split_beam(bvh, eye, dirs, planes, height, width, tile_px, queue,
               k_leaf, steps, t_eps, chunk=beam.BEAM_CHUNK, record=None,
               window=False):
    """Kernel L's design in PyTorch: ``(t, u, v, slot)`` row-major, and
    the number of rounds.  A ``record`` list receives each round's
    ``(q_first, q_count, q_n, items)`` and then the keys ``[T, R]``.  With
    ``window``, the walks are `window_walk_round`'s over the kernels' node
    rows."""
    node_rows, _ = traverse.kernel_rows(bvh)
    d_tiles = tile_pixels(dirs, height, width, tile_px)
    num_tiles, rays = d_tiles.shape[:2]
    num_slots = bvh.packed_tris.shape[0]
    miss = beam.beam_key(torch.tensor([float(FLT_MAX)]),
                         torch.zeros(1, dtype=torch.int64))
    keys = miss.expand(num_tiles, rays).clone()
    cur = torch.zeros(num_tiles, dtype=torch.int64)
    firsts = []
    while True:
        r = len(firsts)
        tile_tmax = beam.beam_key_t(keys.amax(dim=1))
        if window:
            cur, q_first, q_count, q_n = window_walk_round(
                node_rows, cur, queue, steps,
                lambda t, bmin, bmax: beam._beam_enter(
                    planes[t].expand(32, 5, 3), eye, bmin, bmax,
                    tile_tmax[t]))
        else:
            cur, q_first, q_count, q_n = beam._walk_round(
                bvh, cur, queue, steps,
                lambda bmin, bmax: beam._beam_enter(planes, eye, bmin, bmax,
                                                    tile_tmax))
        firsts.append(q_first)
        items = beam.split_queue(q_n, chunk)
        if record is not None:
            record.append((q_first, q_count, q_n, items))
        for tile, lo, hi in items.T.tolist():
            t_item, ord_item = [], []
            for e in range(lo, hi):
                k = torch.arange(min(int(q_count[tile, e]), k_leaf))
                rows, _ = beam.candidate_row_slot(q_first[tile, e], k,
                                                  num_slots)
                t, _, _ = traverse.row_mt(bvh.packed_tris[rows][None], eye,
                                          d_tiles[tile][:, None], t_eps)
                t_item.append(t)
                ord_item.append(beam.candidate_ordinal(r, e, k, queue))
            t_all = torch.cat(t_item, dim=1)
            ordinal = torch.cat(ord_item)
            t_min, j = t_all.min(dim=1)  # each ray's first minimum
            key = torch.where(t_min < float(FLT_MAX),
                              beam.beam_key(t_min, ordinal[j]), miss)
            keys[tile] = torch.minimum(keys[tile], key)
        if not bool((cur >= 0).any()):
            break
    if record is not None:
        record.append(keys)
    hit = keys < miss
    rnd, entry, k = beam.ordinal_entry(keys & 0xFFFFFFFF, queue)
    tiles = torch.arange(num_tiles)[:, None].expand(keys.shape)
    first = torch.stack(firsts)[rnd.clamp(max=len(firsts) - 1), tiles,
                                entry]
    rows, slots = beam.candidate_row_slot(first, k, num_slots)
    t, u, v = traverse.row_mt(bvh.packed_tris[rows], eye, d_tiles, t_eps)
    out = (torch.where(hit, t, float(FLT_MAX)), torch.where(hit, u, 0.0),
           torch.where(hit, v, 0.0), torch.where(hit, slots, 0))
    return tuple(untile_pixels(x, height, width, tile_px) for x in out), \
        len(firsts)


@pytest.fixture(scope="module")
def beam_inputs():
    """name: `_beam_plain`'s arguments on each `BEAM_CASES` frame."""
    out = {}
    for name, (mesh, leaf, side, tile_px, queue, eye, pose) in \
            BEAM_CASES.items():
        verts, faces = mesh()
        dirs = np.array(jcamera.camera_ray_grid(side, side))
        if pose is not None:
            orient = orient_from_pan_pitch(*pose).astype(np.float32)
            dirs = (dirs @ orient.T).astype(np.float32)
        eye = torch.zeros(3) if eye is None else torch.tensor(
            eye, dtype=torch.float32)
        cfg = BvhConfig(max_leaf_faces=leaf)
        bvh = build_bvh(torch.from_numpy(verts),
                        torch.from_numpy(faces.astype(np.int64)), cfg)
        dirs = torch.from_numpy(dirs)
        planes = tile_frustum_planes(tile_pixels(dirs, side, side, tile_px),
                                     tile_px).contiguous()
        out[name] = (bvh, eye, dirs, planes, side, side, tile_px, queue,
                     leaf, beam.walk_steps(cfg.max_iters), np.float32(1e-4))
    return out


@pytest.mark.parametrize("window", [False, True], ids=["walk", "window"])
@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_split_beam_equals_plain(beam_inputs, case, window):
    """The split design's result is the sequential one, bit for bit, with
    the tiles' walks taken one step at a time or 32 rows at a time."""
    args = beam_inputs[case]
    want = beam._beam_plain(*args, tiles_per_chunk=8)
    got, rounds = split_beam(*args, window=window)
    np.testing.assert_array_equal(got[3].int().numpy(), want[3].numpy())
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.numpy().view(np.int32))
    if "queue4" in case:
        assert rounds > 2


@pytest.mark.parametrize("chunk", [1, 3, 4, 32])
def test_split_queue_covers_each_entry_once(chunk):
    """Items hold at most ``chunk`` entries and cover each (tile, entry)
    of every queue once, tile by tile in queue order."""
    q_n = torch.from_numpy(np.random.default_rng(chunk).integers(
        0, 40, 50))
    q_n[:3] = torch.tensor([0, chunk, chunk + 1])
    items = beam.split_queue(q_n, chunk)
    assert items.shape[0] == 3
    tile, lo, hi = items.tolist()
    assert all(0 < h - l <= chunk for l, h in zip(lo, hi))
    covered = [(t, e) for t, l, h in zip(tile, lo, hi) for e in range(l, h)]
    assert covered == [(t, e) for t in range(q_n.numel())
                       for e in range(int(q_n[t]))]
    assert beam.split_queue(torch.zeros(4, dtype=torch.int64),
                            chunk).shape == (3, 0)


def sequential_winner(t, first, k, num_slots):
    """A strict-``<`` scan over candidates in order: (t, row, slot) of the
    first minimum, or None."""
    best = None
    for i in range(len(t)):
        if t[i] < np.float32(FLT_MAX) and (best is None or t[i] < best[0]):
            best = (t[i], max(first[i], 0) + k[i],
                    min(max(first[i] + k[i], 0), num_slots - 1))
    return best


@pytest.mark.parametrize("seed", range(6))
def test_beam_key_is_sequential_first_minimum(seed):
    """The smallest key over a tile's candidate sequence (rounds of queue
    entries, then k) decodes to the sequential first minimum's row and
    slot: exact-t ties (repeats, -0.0 beside +0.0, negative t), misses and
    ``first = -1`` entries, whose tested row and recorded slot part."""
    rng = np.random.default_rng(seed)
    queue, num_slots = int(rng.integers(1, 6)), 80
    rounds = int(rng.integers(1, 4))
    cand = []  # (round, entry, first, k)
    firsts = np.full((rounds, queue), -7)
    for r in range(rounds):
        for e in range(int(rng.integers(1, queue + 1))):
            first = -1 if rng.random() < 0.3 else int(rng.integers(0, 16))
            firsts[r, e] = first
            cand += [(r, e, first, k) for k in range(int(rng.integers(1, 7)))]
    pool = np.array([0.5, 0.25, -0.0, 0.0, -1.5, 2.0, FLT_MAX], np.float32)
    for _ in range(20):
        t = pool[rng.integers(0, pool.size, len(cand))]
        r, e, first, k = (np.array(c) for c in zip(*cand))
        want = sequential_winner(t, first, k, num_slots)
        ordinal = beam.candidate_ordinal(torch.from_numpy(r),
                                         torch.from_numpy(e),
                                         torch.from_numpy(k), queue)
        keys = beam.beam_key(torch.from_numpy(t), ordinal)
        keys = torch.where(torch.from_numpy(t) < float(FLT_MAX), keys,
                           beam.beam_key(torch.tensor([float(FLT_MAX)]),
                                         torch.zeros(1, dtype=torch.int64)))
        best = keys.min()
        if want is None:
            assert bool((keys == best).all()) and \
                float(beam.beam_key_t(best)) == float(FLT_MAX)
            continue
        rr, ee, kk = beam.ordinal_entry(best & 0xFFFFFFFF, queue)
        row, slot = beam.candidate_row_slot(
            torch.tensor(int(firsts[int(rr), int(ee)])), kk, num_slots)
        assert (int(row), int(slot)) == want[1:]
        assert float(beam.beam_key_t(best)) == float(want[0])


def test_beam_key_t_reads_back_t():
    """`beam_key_t` inverts `beam_key`'s high word (-0.0 as +0.0), and the
    keys order as their t do."""
    t = torch.tensor([1.0, -0.0, 0.0, -1.0, float(FLT_MAX), -3e38, 1e-40,
                      float("inf"), -float("inf"), 7.5])
    keys = beam.beam_key(t, torch.arange(t.numel()))
    back = beam.beam_key_t(keys)
    np.testing.assert_array_equal(back.numpy(),
                                  torch.where(t == 0, 0.0, t).numpy())
    assert not bool(torch.signbit(back[1]))
    assert torch.argsort(keys).tolist() == [8, 5, 3, 1, 2, 6, 0, 9, 4, 7]


def walk_nodes(a, skip, enter):
    """The nodes a walk over links ``a``, ``skip`` visits from row 0 when
    it enters exactly the nodes ``enter(node)`` says."""
    seq, cur = [], 0
    while cur >= 0:
        seq.append(cur)
        cur = a[cur] if a[cur] >= 0 and enter(cur) else skip[cur]
    return seq


@pytest.mark.parametrize("mesh, leaf", [
    (lambda: random_mesh(50, 8), 4), (lambda: random_mesh(300, 3), 16),
    (lambda: random_mesh(37, 1), 1), (lambda: big_triangles(2), 16)])
def test_kernel_rows(mesh, leaf):
    """The kernels' rows hold the packed tree bit for bit in `walk_order`
    (node rows: box bits, a-link, skip link renumbered; triangle rows: v0,
    v1 - v0, v2 - v0, zeros), a walk that enters every box visits rows 0,
    1, 2, ..., any walk visits the same nodes as on the packed tree, and
    the copy is built once per structure and again after an in-place
    change."""
    verts, faces = mesh()
    bvh = build_bvh(torch.from_numpy(verts),
                    torch.from_numpy(faces.astype(np.int64)),
                    BvhConfig(max_leaf_faces=leaf))
    nodes, tris = traverse.kernel_rows(bvh)
    row_of = traverse.walk_order(bvh.packed_links)
    assert sorted(row_of.tolist()) == list(range(row_of.numel()))
    assert nodes.dtype == torch.int32 and nodes.shape == (row_of.numel(), 8)
    np.testing.assert_array_equal(
        nodes[row_of, :6].numpy(), bvh.packed_nodes.numpy().view(np.int32))
    links = bvh.packed_links.long()
    want = torch.where(links >= 0, row_of[links.clamp(min=0)], links)
    np.testing.assert_array_equal(nodes[row_of, 6:].numpy(), want.numpy())
    a, skip = nodes[:, 6].tolist(), nodes[:, 7].tolist()
    every = walk_nodes(a, skip, lambda n: True)
    assert every == list(range(len(every)))
    node_of = torch.argsort(row_of).tolist()
    pa, ps = links[:, 0].tolist(), links[:, 1].tolist()
    for mod in (2, 3, 5):
        def enter(node):
            return (node * 7919) % mod != 0
        assert [node_of[r] for r in walk_nodes(
            a, skip, lambda r: enter(node_of[r]))] == walk_nodes(pa, ps,
                                                                 enter)
    p = bvh.packed_tris.numpy()
    want = np.concatenate([p[:, :3], p[:, 3:6] - p[:, :3],
                           p[:, 6:9] - p[:, :3], np.zeros_like(p[:, :3])], 1)
    np.testing.assert_array_equal(tris.numpy().view(np.int32),
                                  want.view(np.int32))
    assert traverse.kernel_rows(bvh)[0] is nodes
    was = float(tris[0, 0])
    bvh.packed_tris[0, 0] += 1.0
    again = traverse.kernel_rows(bvh)
    assert again[1] is not tris and float(again[1][0, 0]) == was + 1.0


def test_walk_order_needs_a_threaded_tree():
    """Links that are not a threaded tree (here a skip link back to the
    root) have no walk order, and the kernels refuse them."""
    links = torch.tensor([[1, -1], [-66, 2], [-67, 0]], dtype=torch.int32)
    assert traverse.walk_order(links) is None
    assert traverse.walk_order(torch.tensor(
        [[1, -1], [-66, 2], [-67, -1]], dtype=torch.int32)) is not None
    bvh = build_bvh(*(torch.from_numpy(x.astype(y)) for x, y in zip(
        big_triangles(2), (np.float32, np.int64))), BvhConfig())
    bvh = bvh._replace(packed_nodes=bvh.packed_nodes[:3].clone(),
                       packed_links=links)
    with pytest.raises(ValueError, match="threaded tree"):
        traverse.kernel_rows(bvh)
