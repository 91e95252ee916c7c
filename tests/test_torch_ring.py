"""The port's primitive ring (`raytracercuda_torch.parallel.ring`) on two
and three gloo ranks on the CPU: bit-equal to the replicated
`bounce_sweep.trace_rays` (all rays, an active mask, the any-hit form, a
triangle copied across shards, padding clusters), and at the bundle bar of
`test_torch_pipeline_bundles.py` against the JAX package's
`trace_ring_sharded` on a mesh of as many CPU devices."""

import numpy as np
import pytest
import torch

from torch_parity import time_limit
from torch_dist_workers import launch, ring_traces, tie_clusters, tri_soup

import jax.numpy as jnp

from raytracercuda_tpu.accel.clusters import build_clusters as jax_build
from raytracercuda_tpu.config import ClusterConfig as JaxClusterConfig
from raytracercuda_tpu.config import TraceConfig as JaxTraceConfig
from raytracercuda_tpu.parallel import ring as jring

from raytracercuda_torch.accel.clusters import ClusterSet, build_clusters
from raytracercuda_torch.config import ClusterConfig, TraceConfig
from raytracercuda_torch.models.camera import camera_ray_grid
from raytracercuda_torch.parallel.ring import (
    _combine,
    pad_clusters_for_ring,
    trace_ring_sharded,
)
from raytracercuda_torch.trace.bounce_sweep import trace_rays
from raytracercuda_torch.trace.sweep import segment_blocks
from raytracercuda_torch.types import FLT_MAX, Hit

SOUP, CLUSTER, SIDE = 600, 16, 24
ORIGIN = (0.1, -0.2, 0.0)


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own limit: far above its time on one worker (< 15 s);
    `launch` also stops its ranks after 120 s."""
    with time_limit(180):
        yield


def replicated(cs, origin, dirs, active=None):
    return trace_rays(cs, segment_blocks(cs), origin, dirs,
                      trace_cfg=TraceConfig(), active=active)


def soup_rays():
    verts, faces = tri_soup(SOUP)
    cs = build_clusters(torch.from_numpy(verts), torch.from_numpy(faces),
                        ClusterConfig(cluster_size=CLUSTER))
    dirs = camera_ray_grid(SIDE, SIDE, device="cpu")
    return cs, torch.tensor(ORIGIN).expand(dirs.shape), dirs


@pytest.mark.parametrize("world", [2, 3])
def test_ring_bit_equal_to_replicated(tmp_path, world):
    """Every rank's t, u, v and face equal the replicated trace's, with
    every ray and with every other ray active; the any-hit form equals the
    replicated hit mask; the triangle planted in clusters 0 and 7 (an exact
    t tie across shards) resolves to the lower shard's face, as on one
    card.  At three ranks the soup's 38 clusters and the tie's 8 are padded
    (`pad_clusters_for_ring`)."""
    ranks = launch(ring_traces, world, tmp_path, SOUP, CLUSTER, SIDE)
    cs, origin, dirs = soup_rays()
    active = torch.arange(dirs.shape[0]) % 2 == 0
    want = {"all": replicated(cs, origin, dirs),
            "active": replicated(cs, origin, dirs, active)}
    assert (want["all"].face >= 0).any() and (want["all"].face < 0).any()
    cmin, cmax, tris, face_order = (torch.from_numpy(x)
                                    for x in tie_clusters())
    tie_cs = ClusterSet(cmin=cmin, cmax=cmax, tris=tris,
                        face_order=face_order)
    tdirs = camera_ray_grid(8, 8, device="cpu")
    want["tie"] = replicated(tie_cs, torch.zeros_like(tdirs), tdirs)
    assert (want["tie"].face == 5).any() and not (want["tie"].face == 9).any()
    for got in ranks:
        for name, w in want.items():
            for field in Hit._fields:
                assert torch.equal(getattr(got[name], field),
                                   getattr(w, field)), (name, field)
        assert torch.equal(got["occluded"], want["all"].face >= 0)
    assert (want["active"].face[~active] == -1).all()


def test_padding_clusters_are_culled():
    """Padding clusters are far point boxes that no ray's slab test
    enters, with zero triangles and face ids -1; ``face_rank`` stays."""
    verts, faces = tri_soup(10, seed=7)
    cs = build_clusters(torch.from_numpy(verts), torch.from_numpy(faces),
                        ClusterConfig(cluster_size=16))
    padded = pad_clusters_for_ring(cs, 8)
    c = cs.num_clusters
    assert padded.num_clusters == 8 and c < 8
    assert (padded.cmin[c:] == 3.0e37).all() and (padded.cmax[c:] == 3.0e37
                                                  ).all()
    assert (padded.tris[c:] == 0).all() and (padded.face_order[c * 16:]
                                             == -1).all()
    assert padded.face_rank is cs.face_rank
    assert pad_clusters_for_ring(padded, 8) is padded
    d = camera_ray_grid(4, 4, device="cpu")
    inv = torch.where(d == 0.0, 3.0e37, 1.0 / d)
    t0 = 3.0e37 * inv
    assert not (t0.amin(dim=-1) >= t0.amax(dim=-1).clamp(min=0.0)).any()


def test_combine_ties_go_to_the_lower_shard():
    """`_combine`: a strict ``<``; on an exact t tie (-0.0 ties +0.0) the
    hit from the lower global shard wins, a miss never does."""
    def hit(t, face):
        t = torch.tensor(t, dtype=torch.float32)
        return Hit(t=t, u=t * 0.5, v=t * 0.25,
                   face=torch.tensor(face, dtype=torch.int32))

    a = hit([1.0, 2.0, 0.0, float(FLT_MAX), 3.0], [1, 2, 3, -1, 4])
    b = hit([1.0, 1.5, -0.0, float(FLT_MAX), 3.0], [7, 8, 9, -1, 6])
    src_a = torch.tensor([2, 2, 2, 2, 0], dtype=torch.int32)
    src_b = torch.tensor([1, 3, 0, 0, 1], dtype=torch.int32)
    best, src = _combine(a, src_a, b, src_b)
    assert best.face.tolist() == [7, 8, 9, -1, 4]
    assert src.tolist() == [1, 3, 0, 2, 0]


def test_ring_rejects_uneven_shapes():
    """The ValueErrors of `ring.py:176-183`."""
    class Ring:
        def size(self):
            return 3

    cs, origin, dirs = soup_rays()
    with pytest.raises(ValueError, match="pad_clusters_for_ring"):
        trace_ring_sharded(cs._replace(cmin=cs.cmin[:37], cmax=cs.cmax[:37]),
                           origin, dirs, Ring())
    padded = pad_clusters_for_ring(cs, 3)
    with pytest.raises(ValueError, match="pad_rays_for_mesh"):
        trace_ring_sharded(padded, origin[:-1], dirs[:-1], Ring())


@pytest.mark.parametrize("world", [2, 3])
def test_ring_meets_jax_ring(tmp_path, world):
    """Against JAX's `trace_ring_sharded` on ``world`` CPU devices: faces
    equal but for exact t ties (t within 1e-6 relative), t, u and v within
    1e-5 relative and 5e-5 absolute on hits (XLA on the CPU contracts
    multiply-adds)."""
    ranks = launch(ring_traces, world, tmp_path, SOUP, CLUSTER, SIDE)
    verts, faces = tri_soup(SOUP)
    jcs = jring.pad_clusters_for_ring(jax_build(
        jnp.asarray(verts), jnp.asarray(faces),
        JaxClusterConfig(cluster_size=CLUSTER)), world)
    dirs = camera_ray_grid(SIDE, SIDE, device="cpu").numpy()
    origin = np.broadcast_to(np.asarray(ORIGIN, np.float32), dirs.shape)
    want = jring.trace_ring_sharded(jcs, jnp.asarray(origin),
                                    jnp.asarray(dirs),
                                    jring.make_ring_mesh(world),
                                    JaxTraceConfig())
    got = ranks[0]["all"]
    wf, gf = np.asarray(want.face), got.face.numpy()
    wt, gt = np.asarray(want.t), got.t.numpy()
    tie = np.abs(gt - wt) <= 1e-6 * np.abs(wt)
    assert (tie | (wf == gf)).all()
    same = (wf >= 0) & (wf == gf)
    assert same.sum() > 0.9 * (wf >= 0).sum() > 0
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   np.asarray(getattr(want, name))[same],
                                   rtol=1e-5, atol=5e-5, err_msg=name)
    assert (gt[wf < 0] == FLT_MAX).all()
