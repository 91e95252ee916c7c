"""Parity of the port's cluster build, culls, per-tile lists and shade
blocks with the JAX package on the CPU.  Masks, lists and the Morton order
must match exactly: slot ids reach the outputs and decide ties."""

import numpy as np
import pytest
import torch

from torch_parity import (
    SIDE,
    jax_scene,
    numpy_scene,
    torch_clusters,
    torch_scene,
)

import jax.numpy as jnp

from raytracercuda_tpu.accel.clusters import build_clusters as jax_build
from raytracercuda_tpu.config import ClusterConfig
from raytracercuda_tpu.models.camera import camera_ray_grid
from raytracercuda_tpu.models.procedural import bumpy_sphere_mesh
from raytracercuda_tpu.trace import dense as jdense
from raytracercuda_tpu.trace import occlusion_cull as jcull
from raytracercuda_tpu.trace import pallas_sweep as jsweep

from raytracercuda_torch.accel.clusters import build_clusters
from raytracercuda_torch.trace import dense as tdense
from raytracercuda_torch.trace import occlusion_cull as tcull
from raytracercuda_torch.trace import sweep as tsweep


def bumpy_fields(num_faces):
    m = bumpy_sphere_mesh(num_faces, seed=2)
    pos = m.positions
    faces = np.concatenate([m.indices.reshape(-1, 3).astype(np.int32),
                            np.zeros((num_faces, 1), np.int32)], axis=1)
    return pos, faces


@pytest.mark.parametrize("case", ["sphere900", "sphere2500", "bumpy3000",
                                  "bumpy_g64"])
def test_build_clusters_exact(case):
    g = 64 if case == "bumpy_g64" else 128
    if case.startswith("sphere"):
        f = numpy_scene(int(case[6:]), seed=9)
        pos, faces = f["positions"], f["faces"]
    else:
        pos, faces = bumpy_fields(3000)
    want = jax_build(jnp.asarray(pos), jnp.asarray(faces),
                     ClusterConfig(cluster_size=g))
    got = build_clusters(torch.from_numpy(pos), torch.from_numpy(faces),
                         ClusterConfig(cluster_size=g))
    assert got.num_clusters == want.num_clusters
    assert got.cluster_size == g
    for k in ("face_order", "cmin", "cmax", "tris", "face_rank"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    # face_rank inverts face_order; kernels C and H's geometry rows are
    # JAX's component-major blocks, transposed.
    np.testing.assert_array_equal(
        got.face_order[got.face_rank].numpy(), np.arange(faces.shape[0]))
    if want.tri_blocks is not None:
        np.testing.assert_array_equal(
            got.tri_blocks.numpy(),
            np.asarray(want.tri_blocks)[:, :9].transpose(0, 2, 1))
    carried = torch_clusters(want)
    for k in ("face_order", "face_rank", "tri_blocks"):
        np.testing.assert_array_equal(getattr(carried, k).numpy(),
                                      getattr(got, k).numpy(), err_msg=k)


def frame_tiles(num_faces=2500, seed=9, eye=(0.0, 0.0, 0.0)):
    """A JAX cluster set, the port's copy, and the 64x64 planar direction
    tiles as numpy."""
    f = numpy_scene(num_faces, seed=seed)
    js = jax_scene(f)
    jc = jax_build(js.positions, js.faces, ClusterConfig(cluster_size=128))
    d3 = np.asarray(camera_ray_grid(SIDE, SIDE)).T.copy()
    d3_tiles = np.array(jdense.tile_pixels_planar(jnp.asarray(d3), SIDE,
                                                  SIDE, 16))
    return jc, torch_clusters(jc), d3_tiles, np.asarray(eye, np.float32)


def assert_lists_equal(jax_lists, jax_counts, lists):
    counts = np.asarray(jax_counts).reshape(-1)
    np.testing.assert_array_equal(lists.counts.numpy(), counts)
    offs = lists.offsets.numpy()
    np.testing.assert_array_equal(offs[1:] - offs[:-1], counts)
    jl = np.asarray(jax_lists).reshape(counts.shape[0], -1)
    ids = lists.ids.numpy()
    for tile, n in enumerate(counts):
        np.testing.assert_array_equal(ids[offs[tile]:offs[tile] + n],
                                      jl[tile, :n])


@pytest.mark.parametrize("list_width", [32, 4])
def test_frustum_cull_and_lists(list_width):
    jc, tc, d3_tiles, eye = frame_tiles()
    want_planes = np.array(jsweep.tile_planes_planar(jnp.asarray(d3_tiles),
                                                     16))
    planes = tsweep.tile_planes_planar(torch.from_numpy(d3_tiles), 16)
    np.testing.assert_allclose(planes.numpy(), want_planes, rtol=1e-6,
                               atol=1e-7)
    # The same planes into both culls: identical masks.
    want = np.array(jdense._cull_frustum(jnp.asarray(want_planes),
                                         jnp.asarray(eye), jc.cmin, jc.cmax))
    got = tdense._cull_frustum(torch.from_numpy(want_planes),
                               torch.from_numpy(eye), tc.cmin, tc.cmax)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    # JAX's lists (one-hot, or the sort branch when a tile has more than
    # ``list_width`` survivors) against the port's uncapped CSR lists.
    jl, jn = jsweep._tile_lists(jnp.asarray(want), jc.num_clusters,
                                list_width)
    if list_width == 4:
        assert np.asarray(jn).max() > 4  # JAX takes its sort branch
    assert_lists_equal(jl, jn, tsweep._tile_lists(got))


@pytest.mark.parametrize("seed", [5, 6])
def test_swept_beam_cull_and_lists(seed):
    jc, tc, _, _ = frame_tiles(1200, seed=seed)
    rng = np.random.default_rng(seed)
    o3 = (rng.standard_normal((16, 3, 256)) * 0.6
          + np.array([0, 0, 3.0])[None, :, None]).astype(np.float32)
    act = rng.random((16, 256)) < 0.3
    act[3] = False  # a tile with no active ray
    light = np.asarray([0.3, 0.9, -0.3], np.float32)
    jb = jcull.swept_tile_beams_planar(jnp.asarray(o3), jnp.asarray(act),
                                       jnp.asarray(light))
    tb = tcull.swept_tile_beams_planar(torch.from_numpy(o3),
                                       torch.from_numpy(act),
                                       torch.from_numpy(light))
    for k in jb._fields:
        np.testing.assert_allclose(getattr(tb, k).numpy(),
                                   np.asarray(getattr(jb, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # The same beams into both culls: identical masks and lists.
    same = tcull.SweptBeam(*(torch.from_numpy(np.array(x)) for x in jb))
    want = np.asarray(jcull.beam_survive_matrix(jb, jc.cmin, jc.cmax))
    got = tcull.beam_survive_matrix(same, tc.cmin, tc.cmax)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[3].any() and want.any()
    jl, jn = jsweep._tile_lists(jnp.asarray(want), jc.num_clusters, 32)
    assert_lists_equal(jl, jn, tsweep._tile_lists(got))


@pytest.mark.parametrize("kind", ["plain", "uv", "textured"])
def test_shade_segment_blocks(kind):
    f = numpy_scene(900, seed=11, uv=kind == "uv", textured=kind == "textured")
    js, ts = jax_scene(f), torch_scene(f)
    jc = jax_build(js.positions, js.faces, ClusterConfig(cluster_size=128))
    want, want_uv = jsweep.shade_segment_blocks(jc, js)
    got, has_uv = tsweep.shade_segment_blocks(torch_clusters(jc), ts)
    assert has_uv == want_uv == (kind != "plain")
    assert got.shape == (jc.num_clusters, 128, tsweep.SHADE_COLS)
    np.testing.assert_array_equal(got[..., :29].numpy(),
                                  np.asarray(want)[..., :29])
    assert not got[..., 29:].any()


def test_row_major_tiles_and_planes():
    """`tile_pixels`/`untile_pixels` and the row-major frustum planes of
    kernel C's route: tiles exact, planes as the planar route's, lists
    equal to JAX's on the same planes."""
    jc, tc, d3_tiles, eye = frame_tiles()
    d = np.array(camera_ray_grid(SIDE, SIDE))
    want_tiles = np.asarray(jdense.tile_pixels(jnp.asarray(d), SIDE, SIDE,
                                               16))
    got_tiles = tdense.tile_pixels(torch.from_numpy(d), SIDE, SIDE, 16)
    np.testing.assert_array_equal(got_tiles.numpy(), want_tiles)
    np.testing.assert_array_equal(
        tdense.untile_pixels(got_tiles, SIDE, SIDE, 16).numpy(), d)
    want_planes = np.asarray(jdense.tile_frustum_planes(
        jnp.asarray(want_tiles), 16))
    planes = tdense.tile_frustum_planes(got_tiles, 16)
    np.testing.assert_allclose(planes.numpy(), want_planes, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(
        planes.numpy(),
        tsweep.tile_planes_planar(got_tiles.transpose(1, 2), 16).numpy())
    want = np.asarray(jdense._cull_frustum(jnp.asarray(want_planes),
                                           jnp.asarray(eye), jc.cmin,
                                           jc.cmax))
    got = tdense._cull_frustum(planes, torch.from_numpy(eye), tc.cmin,
                               tc.cmax)
    np.testing.assert_array_equal(got.numpy(), want)
    jl, jn = jsweep._tile_lists(jnp.asarray(want), jc.num_clusters, 32)
    assert_lists_equal(jl, jn, tsweep._tile_lists(got))


def test_row_major_swept_beams():
    """`swept_tile_beams` on row-major ``[T, R, 3]`` origins: JAX's beams,
    and the planar route's exactly."""
    rng = np.random.default_rng(8)
    o = (rng.standard_normal((16, 256, 3)) * 0.6
         + np.array([0, 0, 3.0])).astype(np.float32)
    act = rng.random((16, 256)) < 0.3
    act[5] = False
    light = np.asarray([0.4, 0.8, -0.45], np.float32)
    jb = jcull.swept_tile_beams(jnp.asarray(o), jnp.asarray(act),
                                jnp.asarray(light))
    tb = tcull.swept_tile_beams(torch.from_numpy(o), torch.from_numpy(act),
                                torch.from_numpy(light))
    pb = tcull.swept_tile_beams_planar(
        torch.from_numpy(o).transpose(1, 2), torch.from_numpy(act),
        torch.from_numpy(light))
    for k in jb._fields:
        np.testing.assert_allclose(getattr(tb, k).numpy(),
                                   np.asarray(getattr(jb, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      getattr(pb, k).numpy(), err_msg=k)
    assert not tb.tile_any[5] and tb.tile_any.any()
