"""The port's BVH and WAVEFRONT routes through its normal entry points
against the JAX package's, on the CPU: `Scene.create()` with no config,
`Camera.trace_scene` (`Scene.march`), `pipeline.trace_hit` on frames and
on ray bundles, `trace_wavefront`, `FrameRenderer` and `render_rgb` with
its gradients.

Tolerances, stated per check:

  * the built structure: every field equal (node boxes bitwise);
  * face ids equal; t, u and v within 1e-5 relative and 5e-5 absolute (XLA
    on the CPU contracts multiply-adds; the port does not);
  * packed frames within 1 per u8 channel (`tests/test_frame.py:66-70`);
  * `render_rgb` images within 5e-5 absolute of JAX's, the bar of t, u and
    v (a textured pixel's bilinear sample carries their last-bit
    differences: 3.5e-5 measured on one pixel of 1,024), and equal to the
    port's own BRUTE render; BVH gradients within ``rtol=1e-5`` of the
    port's BRUTE gradients on the same scene, as `tests/test_diff.py:
    143-151` holds JAX's BVH against its BRUTE;
  * BVH gradients against `jax.grad` of the same loss on JAX's BVH: within
    ``rtol=1e-4`` and ``1e-3 * max|g|`` absolute.  The route adds nothing
    on either side (each package's BVH gradients equal its BRUTE ones
    bit for bit), but the two packages' float32 gradient arithmetic
    differs: the worst measured gap is 4.8e-4 of max|g| (the eye), the
    same as between the two BRUTE renders, and a float64 run of the port
    puts its float32 gradients 5.5e-4 of max|g| from it and JAX's 6.7e-5.
"""

import numpy as np
import pytest
import torch

from test_torch_api import EYE, api_frame, api_scene
from test_torch_bvh import assert_hits_match, random_mesh
from torch_parity import assert_u8_close, jax_scene, numpy_scene, torch_scene

import jax
import jax.numpy as jnp

import raytracercuda_tpu as jrt
import raytracercuda_tpu.diff.render_grad as jrg
from raytracercuda_tpu.accel.bvh import build_bvh as jax_build
from raytracercuda_tpu.config import BvhConfig as JaxBvhConfig
from raytracercuda_tpu.config import WavefrontConfig as JaxWavefrontConfig
from raytracercuda_tpu.models import procedural as jproc
from raytracercuda_tpu.models.camera import camera_ray_grid as jax_rays
from raytracercuda_tpu.trace import pipeline as jpipe
from raytracercuda_tpu.trace.frame import FrameRenderer as JaxFrameRenderer
from raytracercuda_tpu.trace.wavefront import trace_wavefront as jax_wavefront

import raytracercuda_torch as trt
import raytracercuda_torch.diff.render_grad as trg
from raytracercuda_torch.accel.bvh import Bvh, build_bvh
from raytracercuda_torch.config import BvhConfig, WavefrontConfig
from raytracercuda_torch.models import procedural as tproc
from raytracercuda_torch.models.camera import camera_ray_grid
from raytracercuda_torch.trace import pipeline as tpipe
from raytracercuda_torch.trace.frame import FrameRenderer
from raytracercuda_torch.trace.wavefront import trace_wavefront


def test_scene_create_defaults_to_lbvh():
    """`Scene.create()` with no config builds the LBVH, as the JAX
    package's does, field for field."""
    ts = trt.Scene.create(device="cpu")
    js = jrt.Scene.create()
    assert ts.config.accel is trt.AccelKind.BVH
    for scene, proc in ((ts, tproc), (js, jproc)):
        scene.add_mesh(proc.bumpy_sphere_mesh(600, center=(0.0, 0.0, 0.0)))
        scene.add_mesh(proc.quad_mesh(z=2.5))
    assert isinstance(ts.accel, Bvh)
    for name in Bvh._fields:
        got = getattr(ts.accel, name).numpy()
        want = np.asarray(getattr(js.accel, name))
        if want.dtype == np.float32:
            got, want = got.view(np.int32), want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=name)


# (accel, height, width): 24x40 is a frame the 16-pixel beam tile does not
# divide, which both packages trace with the per-ray walk.
FRAME_CASES = {
    "bvh_32x32": ("BVH", 32, 32),
    "bvh_24x40": ("BVH", 24, 40),
    "wavefront_32x32": ("WAVEFRONT", 32, 32),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_trace_scene_matches_jax(case):
    kind, height, width = FRAME_CASES[case]
    jcfg = jrt.RenderConfig(accel=getattr(jrt.AccelKind, kind))
    tcfg = trt.RenderConfig(accel=getattr(trt.AccelKind, kind))
    orient = trt.orient_from_pan_pitch(0.1, -0.05)
    js, ts = api_scene(jrt, jproc, jcfg), api_scene(trt, tproc, tcfg)
    jcam, want = api_frame(jrt, js, height, width, orient)
    tcam, got = api_frame(trt, ts, height, width, orient)
    assert got.shape == (height * width,)
    assert (want != want[0]).any()
    assert_u8_close(got, want)

    jdirs = jpipe.rotate_rays(jcam.initial_rays, jnp.asarray(orient))
    jhit = jpipe.trace_hit(js.data(), js.accel,
                           jnp.broadcast_to(jnp.asarray(EYE), jdirs.shape),
                           jdirs, jcfg, frame_hw=(height, width),
                           common_origin=jnp.asarray(EYE))
    tdirs = tpipe.rotate_rays(tcam.initial_rays, torch.from_numpy(orient))
    eye = torch.from_numpy(EYE)
    thit = tpipe.trace_hit(ts.data(), ts.accel, eye.expand(tdirs.shape),
                           tdirs, tcfg, frame_hw=(height, width),
                           common_origin=eye)
    assert_hits_match(thit, jhit, min_hits=height * width // 10)


def test_trace_hit_bundle_matches_jax():
    """A BVH bundle with scattered origins and no frame takes the per-ray
    walk on both sides."""
    jcfg = jrt.RenderConfig(accel=jrt.AccelKind.BVH)
    tcfg = trt.RenderConfig(accel=trt.AccelKind.BVH)
    js, ts = api_scene(jrt, jproc, jcfg), api_scene(trt, tproc, tcfg)
    dirs = camera_ray_grid(16, 16, device="cpu")
    origins = torch.from_numpy(np.random.default_rng(4).normal(
        0.0, 0.05, tuple(dirs.shape)).astype(np.float32) + EYE)
    jhit = jpipe.trace_hit(js.data(), js.accel, jnp.asarray(origins.numpy()),
                           jnp.asarray(dirs.numpy()), jcfg)
    thit = tpipe.trace_hit(ts.data(), ts.accel, origins, dirs, tcfg)
    assert_hits_match(thit, jhit, min_hits=25)


@pytest.mark.parametrize("queue,chunk", [(2, 100), (16, 4096)])
def test_wavefront_matches_jax(queue, chunk):
    """A queue of 2 leaves forces many rounds; a ``ray_chunk`` below the
    ray count splits the rays into blocks, the last one short."""
    verts, faces = random_mesh(300, 3)
    dirs = np.array(jax_rays(32, 32))
    eye = np.array([0.1, -0.2, 0.0], np.float32)
    origin = np.broadcast_to(eye, dirs.shape).copy()
    jb = jax_build(jnp.asarray(verts), jnp.asarray(faces),
                   JaxBvhConfig(max_leaf_faces=4))
    want = jax_wavefront(jb, jnp.asarray(verts), jnp.asarray(faces),
                         jnp.asarray(origin), jnp.asarray(dirs),
                         JaxBvhConfig(max_leaf_faces=4), jrt.TraceConfig(),
                         JaxWavefrontConfig(max_hits_per_ray=queue,
                                            ray_chunk=chunk))
    tf = torch.from_numpy(faces.astype(np.int64))
    tv = torch.from_numpy(verts)
    tb = build_bvh(tv, tf, BvhConfig(max_leaf_faces=4))
    got = trace_wavefront(tb, tv, tf, torch.from_numpy(origin),
                          torch.from_numpy(dirs), BvhConfig(max_leaf_faces=4),
                          trt.TraceConfig(),
                          WavefrontConfig(max_hits_per_ray=queue,
                                          ray_chunk=chunk))
    assert_hits_match(got, want, min_hits=100)


# (accel, textured, shadows)
RENDERER_CASES = {
    "bvh_shadows": ("BVH", False, True),
    "bvh_textured_shadows": ("BVH", True, True),
    "bvh_no_shadows": ("BVH", False, False),
    "wavefront_shadows": ("WAVEFRONT", False, True),
    "brute_shadows": ("BRUTE", False, True),
}


@pytest.mark.parametrize("case", sorted(RENDERER_CASES))
def test_frame_renderer_matches_jax(case):
    """`FrameRenderer` off the CLUSTER route: `trace_hit`, shadows through
    `any_hit_bvh` (kernel K's any hit) on BVH and WAVEFRONT and
    `any_hit_brute` on BRUTE, and the per-face rows, against JAX
    `_frame_xla` (which tests every shadow ray by brute force)."""
    kind, textured, shadows = RENDERER_CASES[case]
    side = 32
    f = numpy_scene(900, seed=17, textured=textured)
    js, ts = jax_scene(f), torch_scene(f)
    jcfg = jrt.RenderConfig(accel=getattr(jrt.AccelKind, kind))
    tcfg = trt.RenderConfig(accel=getattr(trt.AccelKind, kind))
    jacc = None if kind == "BRUTE" else jax_build(js.positions, js.faces,
                                                  jcfg.bvh)
    tacc = None if kind == "BRUTE" else build_bvh(ts.positions, ts.faces,
                                                  tcfg.bvh)
    orient = trt.orient_from_pan_pitch(0.05, -0.03)
    want = np.asarray(JaxFrameRenderer(
        js, jacc, jcfg, side, side, shadows=shadows).render(
            jnp.zeros(3), jnp.asarray(orient), jax_rays(side, side)))
    got = FrameRenderer(ts, tacc, tcfg, side, side, shadows=shadows).render(
        torch.zeros(3), torch.from_numpy(orient),
        camera_ray_grid(side, side, device="cpu"))
    assert got.shape == (side * side,) and got.dtype == torch.uint32
    assert want.dtype == np.uint32
    assert (want != want[0]).any()
    assert_u8_close(got.numpy(), want)
    if shadows:  # the shadow test darkened some pixels
        lit = FrameRenderer(ts, tacc, tcfg, side, side,
                            shadows=False).render(
            torch.zeros(3), torch.from_numpy(orient),
            camera_ray_grid(side, side, device="cpu"))
        assert (lit != got).sum() > 5


def render_setup(seed=17):
    f = numpy_scene(1200, seed=seed, textured=True)
    js, ts = jax_scene(f), torch_scene(f)
    rays = np.array(jax_rays(32, 32))
    orient = trt.orient_from_pan_pitch(0.04, -0.03).astype(np.float32)
    eye = np.asarray((0.05, -0.02, 1.0), np.float32)
    return js, ts, rays, eye, orient


@pytest.mark.parametrize("frame", [True, False])
def test_render_rgb_gradients_on_bvh(frame):
    """`render_rgb` on BVH (kernel L's or K's plain version, shadows by K's
    any-hit walk) with and without ``frame_hw``: the image equals JAX's,
    its gradients are JAX's within the bar of the module docstring, and
    they equal those of the same render on BRUTE."""
    js, ts, rays, eye, orient = render_setup()
    kw = dict(with_shadows=True, frame_hw=(32, 32) if frame else None)
    jcfg = jrt.RenderConfig(accel=jrt.AccelKind.BVH)
    tcfg = trt.RenderConfig(accel=trt.AccelKind.BVH)
    jbvh = jax_build(js.positions, js.faces, jcfg.bvh)

    def jax_loss(p, a, t, e):
        img = jrg.render_rgb(js._replace(positions=p, albedo=a, textures=t),
                             jbvh, jnp.asarray(rays), e, jnp.asarray(orient),
                             jcfg, **kw)
        return jnp.mean((img - 0.25) ** 2), img

    (_, want), g_jax = jax.value_and_grad(jax_loss, argnums=range(4),
                                          has_aux=True)(
        js.positions, js.albedo, js.textures, jnp.asarray(eye))
    want = np.asarray(want)

    def grads(config, accel):
        leaves = [x.clone().requires_grad_() for x in (
            ts.positions, ts.albedo, ts.textures, torch.from_numpy(eye))]
        p, a, t, e = leaves
        img = trg.render_rgb(ts._replace(positions=p, albedo=a, textures=t),
                             accel, torch.from_numpy(rays), e,
                             torch.from_numpy(orient), config, **kw)
        torch.mean((img - 0.25) ** 2).backward()
        return img.detach(), [x.grad.numpy() for x in leaves]

    img, g_bvh = grads(tcfg, build_bvh(ts.positions, ts.faces, tcfg.bvh))
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=5e-5)
    for name, g, w in zip(("positions", "albedo", "textures", "eye"), g_bvh,
                          g_jax):
        w = np.asarray(w)
        assert g.shape == w.shape and np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)
    img_brute, g_brute = grads(trt.RenderConfig(accel=trt.AccelKind.BRUTE),
                               None)
    np.testing.assert_array_equal(img.numpy(), img_brute.numpy())
    for name, g, w in zip(("positions", "albedo", "textures", "eye"), g_bvh,
                          g_brute):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)
