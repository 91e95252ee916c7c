"""The port's GRID routes through its normal entry points against the JAX
package's, on the CPU: `Scene.create(GRID)` with `Camera.trace_scene`
(`Scene.march`), `pipeline.trace_hit` on a bundle, `FrameRenderer` (the
march, then shadows by kernel E's plain version, JAX `_frame_xla`), and
`render_rgb`, `render_rgb_vjp` and `l2_image_loss` with their gradients.

Tolerances, stated per check:

  * face ids equal; t, u and v within 1e-5 relative and 5e-5 absolute
    (XLA on the CPU contracts multiply-adds; the port does not);
  * packed frames within 1 per u8 channel (`tests/test_frame.py:66-70`);
  * `render_rgb` images within 1e-5 absolute of JAX's (no texture here,
    so no bilinear sample carries t/u/v's last bits);
  * gradients within ``rtol=1e-4`` and ``1e-3 * max|g|`` absolute of
    `jax.grad` of the same loss, the bar of `test_torch_bvh_routes.py`
    (the two packages' float32 gradient arithmetic differs, not the
    route).
"""

import numpy as np
import pytest
import torch

from test_torch_api import EYE, api_frame, api_scene
from test_torch_bvh import assert_hits_match
from torch_parity import assert_u8_close, jax_scene, numpy_scene, torch_scene

import jax
import jax.numpy as jnp

import raytracercuda_tpu as jrt
import raytracercuda_tpu.diff.render_grad as jrg
from raytracercuda_tpu.accel.grid import build_grid as jax_build
from raytracercuda_tpu.models import procedural as jproc
from raytracercuda_tpu.models.camera import camera_ray_grid as jax_rays
from raytracercuda_tpu.trace import pipeline as jpipe
from raytracercuda_tpu.trace.frame import FrameRenderer as JaxFrameRenderer

import raytracercuda_torch as trt
import raytracercuda_torch.diff.render_grad as trg
from raytracercuda_torch.accel.grid import HashGrid, build_grid
from raytracercuda_torch.models import procedural as tproc
from raytracercuda_torch.models.camera import camera_ray_grid
from raytracercuda_torch.trace import grid_march
from raytracercuda_torch.trace import pipeline as tpipe
from raytracercuda_torch.trace.frame import FrameRenderer

JCFG = jrt.RenderConfig(accel=jrt.AccelKind.GRID)
TCFG = trt.RenderConfig(accel=trt.AccelKind.GRID)


@pytest.mark.parametrize("height,width", [(16, 16), (12, 20)])
def test_trace_scene_matches_jax(height, width):
    """Config 2's scene through the public API on GRID: the framebuffer
    and the hits of the same frame through `trace_hit`."""
    orient = trt.orient_from_pan_pitch(0.1, -0.05)
    js, ts = api_scene(jrt, jproc, JCFG), api_scene(trt, tproc, TCFG)
    assert isinstance(ts.accel, HashGrid)
    jcam, want = api_frame(jrt, js, height, width, orient)
    tcam, got = api_frame(trt, ts, height, width, orient)
    assert got.shape == (height * width,)
    assert (want != want[0]).any()
    assert_u8_close(got, want)

    jdirs = jpipe.rotate_rays(jcam.initial_rays, jnp.asarray(orient))
    jhit = jpipe.trace_hit(js.data(), js.accel,
                           jnp.broadcast_to(jnp.asarray(EYE), jdirs.shape),
                           jdirs, JCFG, frame_hw=(height, width),
                           common_origin=jnp.asarray(EYE))
    tdirs = tpipe.rotate_rays(tcam.initial_rays, torch.from_numpy(orient))
    eye = torch.from_numpy(EYE)
    grid_march.reset_launch_counts()
    thit = tpipe.trace_hit(ts.data(), ts.accel, eye.expand(tdirs.shape),
                           tdirs, TCFG, frame_hw=(height, width),
                           common_origin=eye)
    assert grid_march.launch_counts["grid_march"] == 0  # CPU: the plain one
    assert_hits_match(thit, jhit, min_hits=height * width // 10)


def test_trace_hit_bundle_matches_jax():
    """Scattered origins and no frame: the same march."""
    js, ts = api_scene(jrt, jproc, JCFG), api_scene(trt, tproc, TCFG)
    dirs = camera_ray_grid(16, 16, device="cpu")
    origins = torch.from_numpy(np.random.default_rng(4).normal(
        0.0, 0.05, tuple(dirs.shape)).astype(np.float32) + EYE)
    jhit = jpipe.trace_hit(js.data(), js.accel, jnp.asarray(origins.numpy()),
                           jnp.asarray(dirs.numpy()), JCFG)
    thit = tpipe.trace_hit(ts.data(), ts.accel, origins, dirs, TCFG)
    assert_hits_match(thit, jhit, min_hits=25)


@pytest.mark.parametrize("shadows", [True, False])
def test_frame_renderer_matches_jax(shadows):
    side = 24
    f = numpy_scene(900, seed=17)
    js, ts = jax_scene(f), torch_scene(f)
    jg = jax_build(js.positions, js.faces, JCFG.grid)
    tg = build_grid(ts.positions, ts.faces, TCFG.grid)
    orient = trt.orient_from_pan_pitch(0.05, -0.03)
    want = np.asarray(JaxFrameRenderer(
        js, jg, JCFG, side, side, shadows=shadows).render(
            jnp.zeros(3), jnp.asarray(orient), jax_rays(side, side)))
    renderer = FrameRenderer(ts, tg, TCFG, side, side, shadows=shadows)
    got = renderer.render(torch.zeros(3), torch.from_numpy(orient),
                          camera_ray_grid(side, side, device="cpu"))
    assert got.shape == (side * side,) and got.dtype == torch.uint32
    assert want.dtype == np.uint32
    assert (want != want[0]).any()
    assert_u8_close(got.numpy(), want)
    if shadows:  # the shadow test darkened some pixels
        lit = FrameRenderer(ts, tg, TCFG, side, side, shadows=False).render(
            torch.zeros(3), torch.from_numpy(orient),
            camera_ray_grid(side, side, device="cpu"))
        assert (lit != got).sum() > 5


SIDE = 24


def render_setup():
    f = numpy_scene(1200, seed=17)
    js, ts = jax_scene(f), torch_scene(f)
    rays = np.array(jax_rays(SIDE, SIDE))
    orient = trt.orient_from_pan_pitch(0.04, -0.03).astype(np.float32)
    eye = np.asarray((0.05, -0.02, 1.0), np.float32)
    return js, ts, rays, eye, orient


@pytest.mark.parametrize("frame", [True, False])
def test_render_rgb_gradients_on_grid(frame):
    """`render_rgb` on GRID without shadows (kernel M's plain version), with
    and without ``frame_hw``: the image equals JAX's and its gradients
    are JAX's within the module docstring's bar; with ``frame_hw``,
    `render_rgb_vjp` gives the same, and without it `l2_image_loss` gives
    JAX's loss."""
    js, ts, rays, eye, orient = render_setup()
    kw = dict(frame_hw=(SIDE, SIDE) if frame else None)
    jg = jax_build(js.positions, js.faces, JCFG.grid)
    tg = build_grid(ts.positions, ts.faces, TCFG.grid)

    def jax_loss(p, a, e):
        img = jrg.render_rgb(js._replace(positions=p, albedo=a), jg,
                             jnp.asarray(rays), e, jnp.asarray(orient),
                             JCFG, **kw)
        return jnp.mean((img - 0.25) ** 2), img

    (loss, want), g_jax = jax.value_and_grad(jax_loss, argnums=range(3),
                                             has_aux=True)(
        js.positions, js.albedo, jnp.asarray(eye))
    want = np.asarray(want)
    assert (np.abs(want - want[0]).max(axis=1) > 0.1).mean() > 0.1

    for render in ((trg.render_rgb, trg.render_rgb_vjp) if frame
                   else (trg.render_rgb,)):
        leaves = [x.clone().requires_grad_() for x in (
            ts.positions, ts.albedo, torch.from_numpy(eye))]
        p, a, e = leaves
        img = render(ts._replace(positions=p, albedo=a), tg,
                     torch.from_numpy(rays), e, torch.from_numpy(orient),
                     TCFG, **kw)
        torch.mean((img - 0.25) ** 2).backward()
        np.testing.assert_allclose(img.detach().numpy(), want, rtol=0,
                                   atol=1e-5)
        for name, x, w in zip(("positions", "albedo", "eye"), leaves, g_jax):
            w = np.asarray(w)
            assert np.abs(w).max() > 0, name
            np.testing.assert_allclose(x.grad.numpy(), w, rtol=1e-4,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=name)
    if frame:
        return
    target = torch.full((SIDE * SIDE, 3), 0.25)
    got = trg.l2_image_loss(ts, tg, torch.from_numpy(rays),
                            torch.from_numpy(eye), torch.from_numpy(orient),
                            target, TCFG, **kw)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
