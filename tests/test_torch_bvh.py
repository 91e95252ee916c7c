"""The port's LBVH (`raytracercuda_torch.accel.bvh`), its per-ray walk
(`trace/traverse.py`, kernel K's plain version), the slab test and the
structure statistics against the JAX package's, on the CPU.

Tolerances, stated per check:

  * the build: every field of `Bvh` equal (Morton order, links, leaf
    ranges, ``is_leaf``), the node boxes and packed rows bitwise equal
    (min and max are exact), signed zeros included;
  * `box_ray_intersect`: bitwise equal (one subtraction and one product a
    slab, nothing to contract), NaN products included;
  * the walk: face ids equal; t, u and v within 1e-5 relative and 5e-5
    absolute (XLA on the CPU contracts multiply-adds; the port does not);
    occlusion masks equal;
  * statistics: equal dicts.
"""

import numpy as np
import pytest
import torch

from torch_parity import torch_clusters

import jax.numpy as jnp

from raytracercuda_tpu.accel import stats as jstats
from raytracercuda_tpu.accel.bvh import build_bvh as jax_build
from raytracercuda_tpu.accel.clusters import build_clusters as jax_clusters
from raytracercuda_tpu.config import BvhConfig as JaxBvhConfig
from raytracercuda_tpu.config import ClusterConfig as JaxClusterConfig
from raytracercuda_tpu.config import TraceConfig as JaxTraceConfig
from raytracercuda_tpu.models.camera import camera_ray_grid
from raytracercuda_tpu.ops.math import box_ray_intersect as jax_box
from raytracercuda_tpu.trace.traverse import any_hit_bvh as jax_any
from raytracercuda_tpu.trace.traverse import trace_bvh as jax_trace

from raytracercuda_torch import interop
from raytracercuda_torch.accel import bvh as tbvh
from raytracercuda_torch.accel import stats as tstats
from raytracercuda_torch.config import BvhConfig, TraceConfig
from raytracercuda_torch.models.camera import orient_from_pan_pitch
from raytracercuda_torch.ops.math import box_ray_intersect
from raytracercuda_torch.trace import traverse

EYE = np.array([0.1, -0.2, 0.0], np.float32)


def random_mesh(num_faces, seed, spread=1.5, z_shift=3.0):
    """``num_faces`` small random triangles in front of the origin, as
    ``tests/test_beam.py`` builds them: ``(positions [3F, 3], faces [F,
    4])`` numpy."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (num_faces, 3)).astype(np.float32)
    base[:, 2] += z_shift
    offs = rng.normal(scale=0.3, size=(num_faces, 2, 3)).astype(np.float32)
    verts = np.concatenate([base[:, None], base[:, None] + offs],
                           axis=1).reshape(-1, 3)
    faces = np.arange(num_faces * 3, dtype=np.int32).reshape(-1, 3)
    faces = np.concatenate([faces, np.zeros((num_faces, 1), np.int32)], 1)
    return verts, faces


def big_triangles(count):
    """``count`` large triangles dead ahead, one behind the other, the
    first at z = 3."""
    tri = np.array([[-2, -2, 3], [2, -2, 3], [0, 2.5, 3]], np.float32)
    verts = np.concatenate([tri + [0.3 * i, 0.1 * i, 0.5 * i]
                            for i in range(count)]).astype(np.float32)
    faces = np.concatenate([np.arange(3 * count).reshape(-1, 3),
                            np.zeros((count, 1), int)], 1).astype(np.int32)
    return verts, faces


def duplicate_centroids():
    """16 copies of one triangle: equal Morton codes throughout
    (`tests/test_bvh.py:154`)."""
    v = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    faces = np.concatenate([np.arange(48).reshape(-1, 3),
                            np.zeros((16, 1), int)], 1).astype(np.int32)
    return np.tile(v, (16, 1)), faces


def signed_zeros():
    """Triangles with +0.0 and -0.0 coordinates side by side: the box
    min/max must order -0.0 below +0.0 as ``jnp.minimum`` does."""
    verts, faces = random_mesh(40, seed=5)
    verts[:, 0] = np.where(np.arange(verts.shape[0]) % 2, 0.0, -0.0)
    return verts, faces


# name: (mesh, max_leaf_faces)
BUILD_CASES = {
    "single_face": (lambda: big_triangles(1), 16),
    "two_faces_leaf1": (lambda: big_triangles(2), 1),
    "two_faces_leaf16": (lambda: big_triangles(2), 16),
    "duplicate_centroids": (duplicate_centroids, 16),
    "signed_zeros": (signed_zeros, 4),
    "f37_leaf1": (lambda: random_mesh(37, 1), 1),
    "f23_leaf2": (lambda: random_mesh(23, 2), 2),
    "f300_leaf4": (lambda: random_mesh(300, 3), 4),
    "f300_leaf16": (lambda: random_mesh(300, 4), 16),
    "f1000_leaf16": (lambda: random_mesh(1000, 6), 16),
}


@pytest.fixture(scope="module")
def builds():
    """name: (numpy mesh, JAX `Bvh` as numpy fields, port `Bvh`)."""
    out = {}
    for name, (mesh, leaf) in BUILD_CASES.items():
        verts, faces = mesh()
        jb = jax_build(jnp.asarray(verts), jnp.asarray(faces),
                       JaxBvhConfig(max_leaf_faces=leaf))
        tb = tbvh.build_bvh(torch.from_numpy(verts),
                            torch.from_numpy(faces.astype(np.int64)),
                            BvhConfig(max_leaf_faces=leaf))
        out[name] = ((verts, faces, leaf),
                     {k: np.asarray(v) for k, v in jb._asdict().items()}, tb)
    return out


def assert_fields_equal(want: dict, got) -> None:
    for name, w in want.items():
        g = getattr(got, name).numpy()
        assert g.shape == w.shape, name
        if w.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=name)


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_matches_jax(builds, case):
    _, want, got = builds[case]
    assert_fields_equal(want, got)
    assert got.packed_links.dtype == torch.int32
    assert got.num_faces == want["face_order"].shape[0]


def test_bvh_from_numpy(builds):
    _, want, built = builds["f300_leaf4"]
    got = interop.bvh_from_numpy(**want, device="cpu")
    assert_fields_equal(want, got)
    for name in got._fields:
        assert getattr(got, name).dtype == getattr(built, name).dtype, name


def test_clz32_and_morton():
    vals = [0, 1, 2, 3, 255, 256, (1 << 16) - 1, 1 << 16, (1 << 31) - 1,
            1 << 31, (1 << 32) - 1, -1, -7]
    got = tbvh._clz32(torch.tensor(vals, dtype=torch.int64)).tolist()
    want = [32 - (v & 0xFFFFFFFF).bit_length() for v in vals]
    assert got == want
    q = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [3, 3, 3]])
    assert tbvh.morton3d(q).tolist() == [0b100, 0b010, 0b001, 0b111111]


@pytest.mark.parametrize("case", ["f23_leaf2", "f300_leaf4",
                                  "duplicate_centroids", "single_face"])
def test_walk_visits_every_leaf(builds, case):
    """The hit-link / skip-link order, walked on the host entering every
    node, enumerates each slot exactly once."""
    _, _, b = builds[case]
    is_leaf, hit = b.is_leaf.tolist(), b.hit_link.tolist()
    skip, first = b.skip_link.tolist(), b.leaf_first.tolist()
    count = b.leaf_count.tolist()
    seen = []
    cur = 0
    while cur != -1:
        if is_leaf[cur]:
            seen += range(first[cur], first[cur] + count[cur])
            cur = skip[cur]
        else:
            cur = hit[cur]
    assert sorted(seen) == list(range(b.num_faces))


def test_box_ray_intersect_matches_jax():
    rng = np.random.default_rng(8)
    n = 4000
    lo = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1.5, (n, 3)).astype(np.float32)
    orig = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    # Aimed near the box centres, so that about half of the rays enter.
    d = ((lo + hi) / 2 - orig
         + rng.normal(scale=0.6, size=(n, 3))).astype(np.float32)
    d[::7, 0] = 0.0  # inf slabs
    orig[::21, 0] = lo[::21, 0]  # 0 * inf = NaN: a miss
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    want = np.asarray(jax_box(*map(jnp.asarray, (lo, hi, orig, inv))))
    got = box_ray_intersect(*map(torch.from_numpy, (lo, hi, orig, inv)))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert (want < 3e38).mean() > 0.2 and (want[::21] == want.max()).all()


def frame_rays(side=32, pan=0.15, pitch=-0.1):
    dirs = np.asarray(camera_ray_grid(side, side))
    orient = orient_from_pan_pitch(pan, pitch).astype(np.float32)
    dirs = (dirs @ orient.T).astype(np.float32)
    return np.broadcast_to(EYE, dirs.shape).copy(), dirs


# name: (build case, max_iters)
TRACE_CASES = {
    "single_face": ("single_face", 4096),
    "two_faces_leaf1": ("two_faces_leaf1", 4096),
    "two_faces_leaf16": ("two_faces_leaf16", 4096),
    "duplicate_centroids": ("duplicate_centroids", 4096),
    "f300_leaf4": ("f300_leaf4", 4096),
    "f300_leaf16": ("f300_leaf16", 4096),
    "f37_leaf1": ("f37_leaf1", 4096),
    "f300_leaf4_max_iters_9": ("f300_leaf4", 9),
}


def assert_hits_match(got, want, min_hits=1):
    face = np.asarray(want.face)
    np.testing.assert_array_equal(got.face.numpy(), face)
    hit = face >= 0
    assert hit.sum() >= min_hits
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[hit],
                                   np.asarray(getattr(want, name))[hit],
                                   rtol=1e-5, atol=5e-5, err_msg=name)
    assert (got.t.numpy()[~hit] == np.float32(3.4028235e38)).all()


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_bvh_matches_jax(builds, case):
    build, max_iters = TRACE_CASES[case]
    (verts, faces, leaf), _, tb = builds[build]
    origin, dirs = frame_rays()
    jb = jax_build(jnp.asarray(verts), jnp.asarray(faces),
                   JaxBvhConfig(max_leaf_faces=leaf))
    want = jax_trace(jb, None, None, jnp.asarray(origin), jnp.asarray(dirs),
                     JaxBvhConfig(max_leaf_faces=leaf, max_iters=max_iters))
    got = traverse.trace_bvh(tb, None, None, torch.from_numpy(origin),
                             torch.from_numpy(dirs),
                             BvhConfig(max_leaf_faces=leaf,
                                       max_iters=max_iters))
    assert got.face.dtype == torch.int32
    assert_hits_match(got, want)


def test_trace_bvh_backward_hits_kept(builds):
    """``clip_backward_hits=False``: rays from inside the cloud keep hits
    at negative t, as JAX's do."""
    (verts, faces, leaf), _, tb = builds["f300_leaf4"]
    rng = np.random.default_rng(9)
    origin = (rng.uniform(-1, 1, (512, 3)) + [0, 0, 3]).astype(np.float32)
    dirs = rng.normal(size=(512, 3)).astype(np.float32)
    jb = jax_build(jnp.asarray(verts), jnp.asarray(faces),
                   JaxBvhConfig(max_leaf_faces=leaf))
    want = jax_trace(jb, None, None, jnp.asarray(origin), jnp.asarray(dirs),
                     JaxBvhConfig(max_leaf_faces=leaf),
                     JaxTraceConfig(clip_backward_hits=False))
    got = traverse.trace_bvh(tb, None, None, torch.from_numpy(origin),
                             torch.from_numpy(dirs),
                             BvhConfig(max_leaf_faces=leaf),
                             TraceConfig(clip_backward_hits=False))
    assert_hits_match(got, want, min_hits=10)


@pytest.mark.parametrize("case", ["f300_leaf4", "f300_leaf16",
                                  "two_faces_leaf16"])
def test_any_hit_bvh_matches_jax(builds, case):
    (verts, faces, leaf), _, tb = builds[case]
    rng = np.random.default_rng(7)
    n = 600
    origin = (rng.uniform(-2, 2, (n, 3)) + [0, 0, 3]).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    t_max = rng.uniform(0.5, 4.0, n).astype(np.float32)
    jb = jax_build(jnp.asarray(verts), jnp.asarray(faces),
                   JaxBvhConfig(max_leaf_faces=leaf))
    want = np.asarray(jax_any(jb, None, None, jnp.asarray(origin),
                              jnp.asarray(dirs), jnp.asarray(t_max),
                              JaxBvhConfig(max_leaf_faces=leaf)))
    got = traverse.any_hit_bvh(tb, None, None, torch.from_numpy(origin),
                               torch.from_numpy(dirs),
                               torch.from_numpy(t_max),
                               BvhConfig(max_leaf_faces=leaf))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < n
    # A scalar t_max, as the gradient route passes FLT_MAX.
    scalar = traverse.any_hit_bvh(tb, None, None, torch.from_numpy(origin),
                                  torch.from_numpy(dirs), 2.0,
                                  BvhConfig(max_leaf_faces=leaf))
    np.testing.assert_array_equal(
        scalar.numpy(), np.asarray(jax_any(
            jb, None, None, jnp.asarray(origin), jnp.asarray(dirs),
            jnp.full((n,), 2.0), JaxBvhConfig(max_leaf_faces=leaf))))


@pytest.mark.parametrize("case", ["f300_leaf4", "f1000_leaf16",
                                  "single_face", "duplicate_centroids"])
def test_bvh_stats_match_jax(builds, case):
    (verts, faces, leaf), _, tb = builds[case]
    jb = jax_build(jnp.asarray(verts), jnp.asarray(faces),
                   JaxBvhConfig(max_leaf_faces=leaf))
    assert tstats.bvh_stats(tb) == jstats.bvh_stats(jb)
    assert tstats.accel_stats(tb) == jstats.accel_stats(jb)


def test_cluster_stats_match_jax():
    verts, faces = random_mesh(700, 11)
    jc = jax_clusters(jnp.asarray(verts), jnp.asarray(faces),
                      JaxClusterConfig())
    tc = torch_clusters(jc)
    assert tstats.cluster_stats(tc) == jstats.cluster_stats(jc)
    assert tstats.accel_stats(tc) == jstats.accel_stats(jc)
    orient = orient_from_pan_pitch(0.05, 0.02).astype(np.float32)
    rays = np.array(camera_ray_grid(32, 32))
    assert (tstats.cluster_traversal_stats(tc, EYE, orient, rays, 32, 32)
            == jstats.cluster_traversal_stats(jc, EYE, orient,
                                              jnp.asarray(rays), 32, 32))
    with pytest.raises(TypeError, match="no stats for"):
        tstats.accel_stats(None)
