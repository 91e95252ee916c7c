"""Parity of the port's small modules with the JAX package on the CPU:
colour packing, vector math, Möller–Trumbore, the camera grid, Morton
codes, pixel tiling, texture sampling, the light basis and scene
flattening.  Inputs are made with numpy from a seed and fed to both."""

import numpy as np
import pytest
import torch

from torch_parity import port_files_importing_jax

import jax.numpy as jnp

from raytracercuda_tpu.accel import bvh as jbvh
from raytracercuda_tpu.models import camera as jcam
from raytracercuda_tpu.models import procedural as jproc
from raytracercuda_tpu.models import scene as jscene
from raytracercuda_tpu.ops import math as jmath
from raytracercuda_tpu.trace import dense as jdense
from raytracercuda_tpu.trace import occlusion_cull as jcull
from raytracercuda_tpu.trace import shade as jshade
from raytracercuda_tpu.trace import shadow as jshadow

from raytracercuda_torch.accel import bvh as tbvh
from raytracercuda_torch.models import camera as tcam
from raytracercuda_torch.models import procedural as tproc
from raytracercuda_torch.models import scene as tscene
from raytracercuda_torch.ops import math as tmath
from raytracercuda_torch.trace import dense as tdense
from raytracercuda_torch.trace import occlusion_cull as tcull
from raytracercuda_torch.trace import shade as tshade
from raytracercuda_torch.trace import shadow as tshadow


def t(x):
    return torch.from_numpy(np.array(x))


def test_port_never_imports_jax():
    assert port_files_importing_jax() == []


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_rgb(seed):
    rng = np.random.default_rng(seed)
    r, g, b = (rng.uniform(-0.3, 1.3, 4096).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jmath.pack_rgb(jnp.asarray(r), jnp.asarray(g),
                                     jnp.asarray(b)))
    got = tmath.pack_rgb(t(r), t(g), t(b)).numpy()
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tmath.unpack_rgb(t(got)).numpy(),
        np.asarray(jmath.unpack_rgb(jnp.asarray(want))))


def test_normalize_and_tri_intersect():
    rng = np.random.default_rng(2)
    o = rng.standard_normal((256, 1, 3)).astype(np.float32)
    d = rng.standard_normal((256, 1, 3)).astype(np.float32)
    v = [rng.standard_normal((1, 64, 3)).astype(np.float32)
         for _ in range(3)]
    np.testing.assert_allclose(
        tmath.normalize(t(d), eps=1e-30).numpy(),
        np.asarray(jmath.normalize(jnp.asarray(d), eps=1e-30)), rtol=1e-6)
    want = jmath.tri_intersect(*(jnp.asarray(x) for x in (o, d, *v)))
    got = tmath.tri_intersect(*(t(x) for x in (o, d, *v)))
    hit_w = np.asarray(want[0]) < 3e38
    np.testing.assert_array_equal(got[0].numpy() < 3e38, hit_w)
    assert hit_w.any()
    # XLA may fuse multiply-adds and sums 3-vectors in its own order, and
    # these random rays cancel heavily: t/u/v agree to ~2e-6 absolute on
    # O(1) values (the frame tests, on camera rays, hold 1e-6 relative).
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy()[hit_w], np.asarray(b)[hit_w],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("args", [
    (64, 64), (48, 32, -1.0, 1.0, 0.75, -0.75, 1.5)])
def test_camera_ray_grid(args):
    np.testing.assert_allclose(tcam.camera_ray_grid(*args, device="cpu").numpy(),
                               np.asarray(jcam.camera_ray_grid(*args)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tcam.orient_from_pan_pitch(0.3, -0.2),
                                  jcam.orient_from_pan_pitch(0.3, -0.2))


def test_morton_codes():
    rng = np.random.default_rng(3)
    c = rng.uniform(-2, 5, (5000, 3)).astype(np.float32)
    smin, smax = c.min(0), c.max(0)
    want = jbvh.morton_codes(jnp.asarray(c), jnp.asarray(smin),
                             jnp.asarray(smax))
    got = tbvh.morton_codes(t(c), t(smin), t(smax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pixel_tiling():
    rng = np.random.default_rng(4)
    x3 = rng.standard_normal((3, 32 * 48)).astype(np.float32)
    tiles = tdense.tile_pixels_planar(t(x3), 32, 48, 16)
    np.testing.assert_array_equal(
        tiles.numpy(),
        np.asarray(jdense.tile_pixels_planar(jnp.asarray(x3), 32, 48, 16)))
    flat = rng.standard_normal((6, 256)).astype(np.float32)
    np.testing.assert_array_equal(
        tdense.untile_pixels(t(flat), 32, 48, 16).numpy(),
        np.asarray(jdense.untile_pixels(jnp.asarray(flat), 32, 48, 16)))


def test_sample_texture():
    rng = np.random.default_rng(5)
    tex = rng.random((2, 8, 8, 3)).astype(np.float32)
    tid = rng.integers(-1, 3, 2048).astype(np.int32)
    u = rng.uniform(-2, 3, 2048).astype(np.float32)
    v = rng.uniform(-2, 3, 2048).astype(np.float32)
    want = jshade.sample_texture(jnp.asarray(tex), jnp.asarray(tid),
                                 jnp.asarray(u), jnp.asarray(v))
    got = tshade.sample_texture(t(tex), t(tid), t(u), t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("light", [(0.4, 0.8, -0.45), (0.95, 0.1, 0.2)])
def test_light_basis_and_box_interval(light):
    l = np.asarray(light, np.float32)
    for a, b in zip(tshadow.light_basis(t(l)),
                    jshadow.light_basis(jnp.asarray(l))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    rng = np.random.default_rng(6)
    lo = rng.standard_normal((100, 3)).astype(np.float32)
    hi = lo + rng.random((100, 3)).astype(np.float32)
    ax = np.asarray(jshadow.light_basis(jnp.asarray(l))[0])
    for a, b in zip(tcull.box_interval(t(lo), t(hi), t(ax)),
                    jcull.box_interval(jnp.asarray(lo), jnp.asarray(hi),
                                       jnp.asarray(ax))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_flatten_meshes():
    jm = [jproc.bumpy_sphere_mesh(500, seed=1), jproc.icosphere_mesh(1)]
    tm = [tproc.bumpy_sphere_mesh(500, seed=1), tproc.icosphere_mesh(1)]
    tm[1].material_id = jm[1].material_id = 1
    mats = [(0.5, 0.6, 0.7, -1, 0.0), (0.2, 0.3, 0.4, 0, 0.5)]
    jmats = [jscene.Material(m[:3], m[3], m[4]) for m in mats]
    tmats = [tscene.Material(m[:3], m[3], m[4]) for m in mats]
    tex = [np.random.default_rng(7).random((4, 6, 3))]
    want = jscene.flatten_meshes(jm, jmats, tex)
    got = tscene.flatten_meshes(tm, tmats, tex, device="cpu")
    for k in ("positions", "faces", "mesh_material", "albedo", "texture_id",
              "textures", "reflectivity"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert sorted(got.attrs) == sorted(want.attrs)
    for s in want.attrs:
        np.testing.assert_array_equal(got.attrs[s].numpy(),
                                      np.asarray(want.attrs[s]))
