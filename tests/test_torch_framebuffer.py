"""Every route of the port that returns a packed frame, against the JAX
package's, on the CPU: the frame is ``torch.uint32``, 4 bytes a pixel,
its ``.numpy()`` is ``np.uint32`` as JAX's ``np.asarray`` is, and it
meets JAX's frame on the same inputs at the bar the route's own tests
hold it to.

Tolerances, stated per route:

  * equal bits: `pack_rgb`, `pack_gray`, `shade_normal_packed`,
    `pack_shaded`, `clear_buffer` and `Camera.clear` (0xFF00FF00 round
    trips);
  * within 1 per u8 channel: `color_gradient` (XLA multiplies by the
    reciprocal of the band width), `blob` (float32 sin/cos may differ by
    an ulp between libraries), and the traced frames, `FrameRenderer.
    render`, `trace_to_buffer` and `Camera.trace_scene` into a
    `RenderTarget` (float32 sums in another order; `test_torch_frame.py`,
    `test_torch_api.py`).
"""

import numpy as np
import pytest
import torch

from torch_parity import (
    assert_u8_close,
    jax_config,
    jax_scene,
    numpy_scene,
    time_limit,
    torch_config,
    torch_scene,
)

import jax.numpy as jnp

import raytracercuda_tpu as jrt
from raytracercuda_tpu.accel.clusters import build_clusters as jax_build
from raytracercuda_tpu.models import procedural as jproc
from raytracercuda_tpu.models.camera import camera_ray_grid as jax_rays
from raytracercuda_tpu.ops import math as jmath
from raytracercuda_tpu.ops.blob import blob as jax_blob
from raytracercuda_tpu.ops.clear import clear_buffer as jax_clear
from raytracercuda_tpu.ops.gradient import color_gradient as jax_gradient
from raytracercuda_tpu.trace import pipeline as jpipe
from raytracercuda_tpu.trace import shade as jshade
from raytracercuda_tpu.trace.frame import FrameRenderer as JaxFrameRenderer
from raytracercuda_tpu.types import Hit as JaxHit

import raytracercuda_torch as trt
from raytracercuda_torch.accel.clusters import build_clusters
from raytracercuda_torch.models import procedural as tproc
from raytracercuda_torch.models.camera import camera_ray_grid
from raytracercuda_torch.ops import math as tmath
from raytracercuda_torch.ops.blob import blob
from raytracercuda_torch.ops.clear import clear_buffer
from raytracercuda_torch.ops.gradient import color_gradient
from raytracercuda_torch.trace import pipeline as tpipe
from raytracercuda_torch.trace import shade as tshade
from raytracercuda_torch.trace.frame import FrameRenderer
from raytracercuda_torch.types import Hit

CLEAR_VALUE = 0xFF00FF00  # above 2^31: the top bit set
EYE = np.array([0.0, 0.0, -2.1], np.float32)  # the reference's start pose
ORIENT = trt.orient_from_pan_pitch(0.05, -0.03)
SIDE = 32  # traced frames: 2x2 tiles of 16 pixels


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own limit: far above its time on one worker (< 15 s)."""
    with time_limit(120):
        yield


def rng_floats(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.2, 1.2, shape).astype(
        np.float32)


def pack_rgb():
    r, g, b = rng_floats(1, (3, 777))
    t = torch.from_numpy
    return (tmath.pack_rgb(t(r), t(g), t(b)),
            jmath.pack_rgb(jnp.asarray(r), jnp.asarray(g), jnp.asarray(b)))


def pack_gray():
    x = rng_floats(2, 777)
    return tmath.pack_gray(torch.from_numpy(x)), jmath.pack_gray(
        jnp.asarray(x))


def synthetic_hit(num_faces: int, rays: int = 500):
    """Hits on random faces at random barycentrics, a fifth of them
    misses, as both packages' `Hit`."""
    rng = np.random.default_rng(3)
    face = rng.integers(0, num_faces, rays).astype(np.int32)
    face[rng.random(rays) < 0.2] = -1
    u = rng.random(rays).astype(np.float32)
    v = ((1.0 - u) * rng.random(rays)).astype(np.float32)
    t = np.where(face >= 0, rng.random(rays) * 4.0, 3.4028235e38).astype(
        np.float32)
    return (Hit(*(torch.from_numpy(x) for x in (t, u, v, face))),
            JaxHit(*(jnp.asarray(x) for x in (t, u, v, face))))


def shade_normal_packed():
    f = numpy_scene(300, seed=5)
    thit, jhit = synthetic_hit(f["faces"].shape[0])
    return (tshade.shade_normal_packed(torch_scene(f), thit),
            jshade.shade_normal_packed(jax_scene(f), jhit))


def pack_shaded():
    rgb = rng_floats(4, (777, 3))
    return tshade.pack_shaded(torch.from_numpy(rgb)), jshade.pack_shaded(
        jnp.asarray(rgb))


def clear():
    got = clear_buffer(1001, CLEAR_VALUE, "cpu")
    assert int(got[0]) == CLEAR_VALUE and int(got.numpy()[-1]) == CLEAR_VALUE
    return got, jax_clear(1001, jnp.uint32(CLEAR_VALUE))


def gradient():
    return color_gradient(60, 40, "cpu"), jax_gradient(60, 40)


def blob_frame():
    return blob(320, 8, 1.25, "cpu"), jax_blob(320, 8, 1.25)


def frame_renderer():
    f = numpy_scene(900, seed=17)
    js, ts = jax_scene(f), torch_scene(f)
    jcfg, tcfg = jax_config(), torch_config()
    renderer = FrameRenderer(ts, build_clusters(ts.positions, ts.faces,
                                                tcfg.cluster),
                             tcfg, SIDE, SIDE, shadows=False)
    want = JaxFrameRenderer(js, jax_build(js.positions, js.faces,
                                          jcfg.cluster), jcfg, SIDE, SIDE,
                            shadows=False).render(
        jnp.zeros(3), jnp.asarray(ORIENT), jax_rays(SIDE, SIDE))
    got = renderer.render(torch.zeros(3), torch.from_numpy(ORIENT),
                          camera_ray_grid(SIDE, SIDE, device="cpu"))
    return got, want


def trace_to_buffer():
    f = numpy_scene(300, seed=11)
    tcfg = trt.RenderConfig(accel=trt.AccelKind.BRUTE)
    jcfg = jrt.RenderConfig(accel=jrt.AccelKind.BRUTE)
    got = tpipe.trace_to_buffer(
        torch_scene(f), None, camera_ray_grid(SIDE, SIDE, device="cpu"),
        torch.zeros(3), torch.from_numpy(ORIENT), tcfg,
        frame_hw=(SIDE, SIDE))
    want = jpipe.trace_to_buffer(
        jax_scene(f), None, jax_rays(SIDE, SIDE), jnp.zeros(3),
        jnp.asarray(ORIENT), jcfg, frame_hw=(SIDE, SIDE))
    return got, want


def api_target(pkg, proc, trace: bool):
    """Config 2's scene at a small size through the public API: a
    `RenderTarget` cleared by `Camera.clear`, then (``trace``) traced by
    `Camera.trace_scene`."""
    kw = {"device": "cpu"} if pkg is trt else {}
    scene = pkg.Scene.create(pkg.RenderConfig(accel=pkg.AccelKind.BRUTE),
                             **kw)
    scene.add_mesh(proc.bumpy_sphere_mesh(300, center=(0.0, 0.0, 0.0)))
    scene.add_mesh(proc.quad_mesh(z=2.5))
    cam = pkg.Camera.create(**kw)
    assert cam.set_initial_rays(SIDE, SIDE, -1, 1, -1, 1, 1) == 0
    rt = pkg.RenderTarget.create(SIDE, SIDE, **kw)
    assert rt.lock() == 0
    assert cam.clear(rt, np.uint32(CLEAR_VALUE)) == 0  # JAX's uint32
    if trace:
        assert cam.trace_scene(EYE, ORIENT, scene, rt) == 0
    assert rt.unlock() == 0
    return rt.buffer


def camera_clear():
    got = api_target(trt, tproc, trace=False)
    assert bool((got == CLEAR_VALUE).all())
    return got, api_target(jrt, jproc, trace=False)


def camera_trace_scene():
    return (api_target(trt, tproc, trace=True),
            api_target(jrt, jproc, trace=True))


# name: (frame route, whether JAX's frame is matched bit for bit).
ROUTES = {
    "pack_rgb": (pack_rgb, True),
    "pack_gray": (pack_gray, True),
    "shade_normal_packed": (shade_normal_packed, True),
    "pack_shaded": (pack_shaded, True),
    "clear_buffer": (clear, True),
    "color_gradient": (gradient, False),
    "blob": (blob_frame, False),
    "FrameRenderer.render": (frame_renderer, False),
    "trace_to_buffer": (trace_to_buffer, False),
    "Camera.clear": (camera_clear, True),
    "Camera.trace_scene": (camera_trace_scene, False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_frame_is_uint32(route):
    make, exact = ROUTES[route]
    got, want = make()
    want = np.asarray(want)
    assert got.dtype == torch.uint32 and got.element_size() == 4
    assert got.untyped_storage().nbytes() == got.numel() * 4
    host = got.numpy()
    assert host.dtype == want.dtype == np.uint32
    assert host.shape == want.shape
    if exact:
        np.testing.assert_array_equal(host, want)
    else:
        assert_u8_close(host, want)
    assert len(np.unique(want)) > 1 or "clear" in route.lower()
