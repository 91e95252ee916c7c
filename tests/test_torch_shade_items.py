"""Kernel A's split sweep, decomposed on the CPU: each tile's list cut into
work items of ``SHADE_CHUNK`` clusters, each item's closest hit merged
per ray by the kernel's 64-bit key, the winner's test re-run on its
geometry row and its attributes interpolated, gives exactly what the
plain version gives over whole lists.  Also the operand the split sweeps
(A, B) share: `segment_blocks` against the shade rows' first nine
columns."""

import functools

import numpy as np
import pytest
import torch

from test_torch_sweep import SPLIT_CASES, _random_lists
from test_torch_sweep import setup as sweep_setup
from torch_parity import numpy_scene, torch_scene

from raytracercuda_torch.accel.clusters import build_clusters
from raytracercuda_torch.config import ClusterConfig
from raytracercuda_torch.trace import sweep as tsweep
from raytracercuda_torch.types import FLT_MAX

# Above every hit's key, as `kMissKey` is in `csrc/hit_key.cuh`.
MISS = torch.iinfo(torch.int64).max


def hit_keys(t: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """A torch copy of `hit_key` (`csrc/hit_key.cuh`): t's bits in an
    unsigned order monotone over the floats, -0.0 as +0.0, above the
    slot.  int64 keys: the ordered bits (< 2**32) times 2**31, plus the
    slot (< 2**31), compare as the kernel's unsigned 64-bit keys do."""
    b = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)  # -0.0
    ordered = torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b ^ 0x80000000)
    return ordered * 2**31 + slot.to(torch.int64)


def split_shade(lists, eye, d3, blocks, geom, has_uv, with_refl, t_eps):
    """Kernel A as its two passes compute it: pass 1's closest hit of each
    work item over the geometry rows, merged per ray by the smallest key;
    pass 2's re-run of the winner's test and its attributes from the shade
    rows.  Outputs as `_primary_shade_plain`'s."""
    num_tiles = d3.shape[0]
    best = torch.full(d3[:, 0].shape, MISS, dtype=torch.int64)
    items = tsweep.split_lists(lists, tsweep.SHADE_CHUNK)
    for tile, first, end in items.T.tolist():
        if first == end:
            continue
        survive = torch.zeros((num_tiles, geom.shape[0]), dtype=torch.bool)
        survive[tile, lists.ids[first:end].long()] = True
        bt, bs, _, _ = tsweep._closest_plain(tsweep._tile_lists(survive), eye,
                                             d3, geom, t_eps)
        best = torch.minimum(best, torch.where(bt < FLT_MAX,
                                               hit_keys(bt, bs), MISS))
    hit = best < MISS
    slot = torch.where(hit, best % 2**31, 0).to(torch.int32)
    row = geom.reshape(-1, tsweep.GEOM_COLS)[slot.long()]  # [T, R, 9]
    t, u, v = tsweep._mt_cols(tuple(row[..., k] for k in range(9)), eye[0],
                              eye[1], eye[2], d3[:, 0], d3[:, 1], d3[:, 2],
                              t_eps)
    t = torch.where(hit, t, float(FLT_MAX))
    u = torch.where(hit, u, 0.0)
    v = torch.where(hit, v, 0.0)
    attrs = tsweep._interpolate_winners(blocks, t, slot, u, v, has_uv,
                                        with_refl)
    return (t, slot, u, v, *attrs)


def assert_same_planes(got, want):
    """Slots equal, every float plane bit-equal."""
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    for k in [0] + list(range(2, len(want))):
        np.testing.assert_array_equal(
            got[k].contiguous().view(torch.int32).numpy(),
            want[k].contiguous().view(torch.int32).numpy(), err_msg=str(k))


@functools.cache
def scene(kind: str, eye=(0.0, 0.0, 0.0)):
    """`test_torch_sweep.setup`'s 5,200-face scene (41 clusters) with the
    port's operands: the shade rows, the geometry rows, the eye."""
    s = sweep_setup(kind, num_faces=5200, seed=3, eye=eye)
    return dict(blocks=s["tblocks"], geom=tsweep.segment_blocks(s["tc"]),
                tris=s["tc"].tris, face_order=s["tc"].face_order,
                has_uv=s["has_uv"], eye=torch.from_numpy(s["eye"]))


def aimed_dirs(s, lists, seed, rays=256):
    """Planar ``[T, 3, R]`` directions from the eye: in a tile with a
    list, 80% toward random points on real triangles of its listed
    clusters (so they hit), the rest, and every ray of an empty tile,
    random."""
    rng = np.random.default_rng(seed)
    num_tiles = lists.counts.numel()
    g = s["tris"].shape[1]
    tris = s["tris"].reshape(-1, 9)
    real = s["face_order"] >= 0
    d = torch.from_numpy(rng.normal(size=(num_tiles, rays, 3)).astype(
        np.float32))
    for t in range(num_tiles):
        lo, hi = int(lists.offsets[t]), int(lists.offsets[t + 1])
        if lo == hi:
            continue
        slots = (lists.ids[lo:hi].long()[:, None] * g
                 + torch.arange(g)).reshape(-1)
        slots = slots[real[slots]].numpy()
        aim = rng.random(rays) < 0.8
        tri = tris[torch.from_numpy(rng.choice(slots, int(aim.sum())))]
        w = torch.from_numpy(rng.dirichlet((1.0, 1.0, 1.0), len(tri)).astype(
            np.float32))
        p = (tri[:, 0:3] * w[:, 0:1] + tri[:, 3:6] * w[:, 1:2]
             + tri[:, 6:9] * w[:, 2:3])
        d[t, torch.from_numpy(aim)] = p - s["eye"]
    return d.transpose(1, 2).contiguous()


def run_case(s, lists, with_refl, t_eps, seed=0, d3=None):
    if d3 is None:
        d3 = aimed_dirs(s, lists, seed)
    args = (lists, s["eye"], d3, s["blocks"])
    want = tsweep._primary_shade_plain(*args, s["has_uv"], with_refl, t_eps)
    got = split_shade(*args, s["geom"], s["has_uv"], with_refl, t_eps)
    assert_same_planes(got, want)
    return want


@pytest.mark.parametrize("with_refl", [False, True])
@pytest.mark.parametrize("kind", ["plain", "uv"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_shade_items_merge_equals_plain(case, kind, with_refl):
    s = scene(kind)
    lists = _random_lists(SPLIT_CASES[case], 40, seed=len(case))
    want = run_case(s, lists, with_refl, np.float32(1e-4), seed=len(case))
    assert len(want) == (12 if kind == "uv" else 9) + with_refl + 1
    hit = want[0] < FLT_MAX
    listing = lists.counts > 0
    assert hit[listing].any() == bool(listing.any())
    assert not hit[~listing].any()


@pytest.mark.parametrize("with_refl", [False, True])
def test_shade_items_inside_no_clip(with_refl):
    """``t_eps`` None with the eye inside the mesh: hits at a negative t
    take part in the merge (their keys order below t = 0)."""
    s = scene("uv", eye=(0.0, 0.0, 3.0))
    lists = _random_lists([40, 17, 40, 3], 40, seed=5)
    want = run_case(s, lists, with_refl, None, seed=5)
    assert (want[0] < 0).any() and (want[0][want[0] < FLT_MAX] > 0).any()


def test_shade_items_tie_takes_the_earlier_slot():
    """A triangle copied into a cluster one work item later in the list:
    the rays aimed at it tie at the same t, and the earlier slot wins, as
    in the JAX kernel's serial sweep."""
    s = dict(scene("uv"))
    lists = _random_lists([40], 40, seed=8)
    ids = lists.ids.long().tolist()
    g = s["geom"].shape[1]
    a = ids[1] * g + 3
    b = ids[1 + tsweep.SHADE_CHUNK] * g + 7  # one item later
    assert bool(s["face_order"][a] >= 0) and bool(s["face_order"][b] >= 0)
    geom, blocks = s["geom"].clone(), s["blocks"].clone()
    geom.view(-1, tsweep.GEOM_COLS)[b] = geom.view(-1, tsweep.GEOM_COLS)[a]
    blocks.view(-1, tsweep.SHADE_COLS)[b] = \
        blocks.view(-1, tsweep.SHADE_COLS)[a]
    s.update(geom=geom, blocks=blocks)
    # An eye just off triangle a's centre, 256 rays through points on it.
    v0, e1, e2 = geom.view(-1, 9)[a].view(3, 3)
    normal = torch.linalg.cross(e1, e2)
    s["eye"] = (v0 + (e1 + e2) / 3 + normal / normal.norm() * 0.25
                * e1.norm()).contiguous()
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.dirichlet((1.0, 1.0, 1.0), 256).astype(
        np.float32))
    p = v0 + w[:, 1:2] * e1 + w[:, 2:3] * e2
    d3 = (p - s["eye"]).T[None].contiguous()
    want = run_case(s, lists, True, np.float32(1e-4), d3=d3)
    assert int((want[1] == a).sum()) > 64
    assert not (want[1] == b).any()


@pytest.mark.parametrize("cached", [True, False])
def test_segment_blocks_equal_shade_columns(cached):
    """The geometry rows every sweep reads are bit-equal to the first
    nine columns of the shade rows that A's epilogue reads, padding slots
    included (1,000 faces: 104 in the last cluster of 128)."""
    fields = numpy_scene(1000, seed=21, uv=True)
    ts = torch_scene(fields)
    cs = build_clusters(ts.positions, ts.faces, ClusterConfig(
        cluster_size=128))
    assert cs.num_clusters * 128 > 1000
    if not cached:
        cs = cs._replace(tri_blocks=None)
    geom = tsweep.segment_blocks(cs)
    shade, _ = tsweep.shade_segment_blocks(cs, ts)
    assert geom.shape == shade.shape[:2] + (tsweep.GEOM_COLS,)
    np.testing.assert_array_equal(
        geom.contiguous().view(torch.int32).numpy(),
        shade[..., :tsweep.GEOM_COLS].contiguous().view(torch.int32).numpy())
    assert (cs.face_order < 0).any()  # padding slots are covered
