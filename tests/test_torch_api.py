"""The port's public API (`Scene`, `Camera`, `RenderTarget`,
`clear_buffer`, `trace.pipeline.trace_to_buffer`) and the rest of
`trace/shade.py` against the JAX package's, on scenes built through both
packages' APIs from the same procedural meshes.

Tolerances, stated per check:

  * `clear_buffer` (kernel D's plain version): equal values, including
    u32 values above 2^31.
  * Status codes: equal to the JAX package's, case by case
    (`tests/test_scene_api.py`, `tests/test_camera.py`).
  * `Camera.trace_scene` frames on BRUTE and CLUSTER against JAX
    `trace_to_buffer`: face ids equal except near-ties (a different winner
    only at a t within 1e-6 relative), and every u8 channel of the packed
    frame within 1 (XLA on the CPU contracts multiply-adds; the port does
    not).
  * `shade_lambert_rgb`'s `FaceTables` route: within 1e-6 absolute of
    JAX's, for the same reason; `pack_shaded` and `shade_normal_packed`:
    equal values.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import (
    assert_slots_match,
    assert_u8_close,
    jax_config,
    jax_scene,
    numpy_scene,
    torch_scene,
)

import jax.numpy as jnp

import raytracercuda_tpu as jrt
from raytracercuda_tpu.models import procedural as jproc
from raytracercuda_tpu.ops.clear import clear_buffer as jax_clear
from raytracercuda_tpu.trace import pipeline as jpipe
from raytracercuda_tpu.trace import shade as jshade
from raytracercuda_tpu.trace.bruteforce import trace_brute as jax_brute
from raytracercuda_tpu.types import Hit as JaxHit

import raytracercuda_torch as trt
from raytracercuda_torch.models import procedural as tproc
from raytracercuda_torch.ops import clear as tclear
from raytracercuda_torch.ops import cuda_build
from raytracercuda_torch.trace import pipeline as tpipe
from raytracercuda_torch.trace import shade as tshade
from raytracercuda_torch.types import Hit

EYE = np.array([0.0, 0.0, -2.1], np.float32)  # the reference's start pose


def cpu(pkg) -> dict:
    """The keyword that puts the port's objects on the CPU (the JAX
    package's constructors take none)."""
    return {"device": "cpu"} if pkg is trt else {}


# ---------------------------------------------------------------------------
# Kernel D and the status codes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_pixels", [1000, 1, 1025, 4096])
def test_clear_buffer_matches_jax(num_pixels):
    value = 0xFF00FF00
    want = np.asarray(jax_clear(num_pixels, jnp.uint32(value)))
    tclear.reset_launch_counts()
    got = tclear.clear_buffer(num_pixels, value, "cpu")
    assert tclear.launch_counts["clear"] == 0  # CPU: the plain version
    assert got.dtype == torch.uint32 and got.shape == (num_pixels,)
    assert got.numpy().dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == 0xFF00FF00).all()  # above 2^31, unsigned


def test_clear_kernel_wrapper_rejects_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        tclear._clear_cuda(16, 7, torch.device("cpu"))


@pytest.mark.parametrize("device", [torch.device("cuda", 0),
                                    torch.device("cuda"), 0])
def test_raw_stream_raises_without_cuda(device):
    """D's and G's wrappers take the stream from `raw_stream`.  On a torch
    built without CUDA it raises, naming the missing call, and never
    returns stream 0 in place of the current stream."""
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        pytest.skip("this torch has CUDA")
    with pytest.raises(RuntimeError, match="_cuda_getCurrentRawStream"):
        cuda_build.raw_stream(device)


def test_importing_cuda_build_builds_nothing():
    """Importing the port, the build module and the lean-path wrappers
    runs no compiler and loads no library; `kernel_fn` looks nothing up
    until it is called."""
    code = "\n".join([
        "import subprocess, torch",
        "def refuse(*a, **k):",
        "    raise AssertionError(f'a process ran at import: {a}')",
        "subprocess.Popen = subprocess.run = refuse",
        "import raytracercuda_torch",
        "from raytracercuda_torch.ops import clear, cuda_build",
        "from raytracercuda_torch.diff import scatter",
        "assert cuda_build.load_library.cache_info().currsize == 0",
        "assert not cuda_build._KERNEL_FNS",
    ])
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr


def test_render_target_lock_state_machine():
    for pkg in (jrt, trt):
        rt = pkg.RenderTarget.create(8, 8, **cpu(pkg))
        assert pkg.RenderTarget.get() is None
        assert rt.lock() == pkg.ERROR_ALL_FINE
        assert pkg.RenderTarget.get() is rt and rt.locked
        assert rt.lock() == pkg.ERROR_UNLOCK_FIRST
        assert rt.unlock() == pkg.ERROR_ALL_FINE
        assert rt.unlock() == pkg.ERROR_LOCK_FIRST
        assert pkg.RenderTarget.get() is None
    assert trt.RenderTarget.create(4, 3, "cpu").image().shape == (3, 4)


def test_camera_validation_matches_jax():
    cases = [(0, 10), (10, 0), (16, 16), (8, 6, -1, 1, -1, 1, 2.0),
             (4, 4, -1, 1, 1, -1, float("inf"))]
    for args in cases:
        jcam, tcam = jrt.Camera.create(), trt.Camera.create("cpu")
        code = jcam.set_initial_rays(*args)
        assert tcam.set_initial_rays(*args) == code, args
        assert (tcam.width, tcam.height) == (jcam.width, jcam.height)
        if code == jrt.ERROR_ALL_FINE:
            np.testing.assert_array_equal(tcam.initial_rays.numpy(),
                                          np.asarray(jcam.initial_rays))
    assert trt.Camera.create("cpu").set_initial_rays(0, 10) \
        == trt.ERROR_INVALID_PARAMETER


def test_camera_clear_codes():
    cam = trt.Camera.create("cpu")
    rt = trt.RenderTarget.create(4, 4, "cpu")
    assert cam.clear(None, 5) == trt.ERROR_NO_RENDER_TARGET
    assert cam.clear(rt, 0x123456) == trt.ERROR_ALL_FINE
    assert (rt.buffer == 0x123456).all() and rt.buffer.shape == (16,)


def tri_mesh(pkg_mesh):
    """`test_scene_api.tri_mesh` for either package's `Mesh` class."""
    from raytracercuda_torch.models.mesh import (VERTEX_DATA_NORMAL,
                                                 VERTEX_DATA_POSITION)

    m = pkg_mesh.create()
    verts = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    normals = np.tile([[0, 0, -1]], (3, 1)).astype(np.float32)
    assert m.set_indices(np.array([0, 1, 2], np.uint32), 3) == 0
    assert m.set_vertex_data(verts, 3, 3, VERTEX_DATA_POSITION) == 0
    assert m.set_vertex_data(normals, 3, 3, VERTEX_DATA_NORMAL) == 0
    return m


def march_codes(pkg):
    """The status codes of `test_scene_api.test_march_validation_codes`'s
    cases and of the camera's own checks, in order."""
    kw = cpu(pkg)
    s = pkg.Scene.create(pkg.RenderConfig(accel=pkg.AccelKind.BRUTE), **kw)
    s.add_mesh(tri_mesh(pkg.Mesh))
    cam = pkg.Camera.create(**kw)
    codes = [cam.trace_scene(np.zeros(3), np.eye(3), s,
                             pkg.RenderTarget.create(8, 8, **kw)),  # no rays yet
             cam.set_initial_rays(8, 8),
             cam.trace_scene(np.zeros(3), np.eye(3), s, None),
             cam.trace_scene(np.zeros(3), np.eye(3), s,
                             pkg.RenderTarget.create(16, 8, **kw)),
             cam.trace_scene(None, np.eye(3), s, None),
             cam.trace_scene(np.zeros(3), np.eye(3), None, None)]
    rt = pkg.RenderTarget.create(8, 8, **kw)
    codes.append(cam.trace_scene(np.zeros(3), np.eye(3), s, rt))
    img = np.asarray(rt.image())
    assert img.dtype == np.uint32
    return codes, img


def test_march_validation_codes_match_jax():
    want, jimg = march_codes(jrt)
    got, timg = march_codes(trt)
    assert got == want == [2, 0, 8, 5, 2, 2, 0]
    assert timg.shape == (8, 8) and (timg != 0).any()
    np.testing.assert_array_equal(timg, jimg)


def test_scene_backends_and_meshes():
    s = trt.Scene.create(trt.RenderConfig(accel=trt.AccelKind.BRUTE), "cpu")
    a, b = tri_mesh(trt.Mesh), tri_mesh(trt.Mesh)
    s.add_mesh(a)
    s.add_mesh(b)
    assert len(s.meshes) == 2 and s.accel is None
    assert s.data().faces.shape == (2, 4)
    s.remove_mesh(a)
    assert len(s.meshes) == 1 and s.meshes[0] is b
    assert s.data().faces.shape == (1, 4)
    c = trt.Scene.create(trt.RenderConfig(accel=trt.AccelKind.CLUSTER), "cpu")
    c.add_mesh(b)
    assert c.accel.num_clusters == 1
    for kind in (trt.AccelKind.BVH, trt.AccelKind.WAVEFRONT):
        lb = trt.Scene.create(trt.RenderConfig(accel=kind), "cpu")
        lb.add_mesh(b)
        assert lb.accel.num_faces == 1 and bool(lb.accel.is_leaf[0])
    g = trt.Scene.create(trt.RenderConfig(accel=trt.AccelKind.GRID), "cpu")
    g.add_mesh(b)
    assert int(g.accel.cell_start[-1]) >= 1 and g.accel.num_cells == 65536


# ---------------------------------------------------------------------------
# The public-API frame.
# ---------------------------------------------------------------------------


def api_scene(pkg, proc, config):
    """Config 2's scene at a small size: a bumpy sphere at the origin and
    the reference's quad behind it."""
    scene = pkg.Scene.create(config, **cpu(pkg))
    scene.add_mesh(proc.bumpy_sphere_mesh(600, center=(0.0, 0.0, 0.0)))
    scene.add_mesh(proc.quad_mesh(z=2.5))
    return scene


def api_frame(pkg, scene, height, width, orient):
    cam = pkg.Camera.create(**cpu(pkg))
    assert cam.set_initial_rays(width, height, -1, 1, -1, 1, 1) == 0
    rt = pkg.RenderTarget.create(width, height, **cpu(pkg))
    assert rt.lock() == 0
    assert cam.trace_scene(EYE, orient, scene, rt) == 0
    assert rt.unlock() == 0
    frame = np.asarray(rt.buffer)
    assert frame.dtype == np.uint32
    return cam, frame


# (accel, height, width): 24x40 is a frame the 16-pixel tile does not
# divide, which JAX traces per ray and the port edge-pads.
FRAME_CASES = {
    "brute_32x32": ("BRUTE", 32, 32),
    "brute_24x40": ("BRUTE", 24, 40),
    "cluster_32x32": ("CLUSTER", 32, 32),
    "cluster_24x40": ("CLUSTER", 24, 40),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_trace_scene_matches_jax(case):
    kind, height, width = FRAME_CASES[case]
    if kind == "CLUSTER":
        jcfg = jax_config()
    else:
        jcfg = jrt.RenderConfig(accel=jrt.AccelKind.BRUTE)
    tcfg = trt.RenderConfig(accel=getattr(trt.AccelKind, kind))
    orient = trt.orient_from_pan_pitch(0.1, -0.05)
    js, ts = api_scene(jrt, jproc, jcfg), api_scene(trt, tproc, tcfg)
    jcam, want = api_frame(jrt, js, height, width, orient)
    tcam, got = api_frame(trt, ts, height, width, orient)
    assert got.shape == (height * width,)
    miss = tshade.MISS_COLOR_PACKED
    assert (want == miss).any() and (want != miss).mean() > 0.15
    assert_u8_close(got, want)

    # The hits behind the frames: faces equal except near-ties.
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
    assert_slots_match(thit.face.numpy(), np.asarray(jhit.face),
                       thit.t.numpy(), np.asarray(jhit.t), max_share=0.01)


def test_bundle_without_common_origin_raises():
    """A CLUSTER bundle without a common origin or a frame, which the port
    refused until it traced such bundles in groups of rays
    (`bounce_sweep.trace_rays`): faces equal to JAX's
    (`dense.trace_clusters_rays`) except near-ties."""
    jcfg = jax_config()
    js = api_scene(jrt, jproc, jcfg)
    ts = api_scene(trt, tproc, trt.RenderConfig(accel=trt.AccelKind.CLUSTER))
    dirs = trt.camera_ray_grid(16, 16, device="cpu")
    origins = torch.from_numpy(np.random.default_rng(4).normal(
        0.0, 0.05, tuple(dirs.shape)).astype(np.float32) + EYE)
    jhit = jpipe.trace_hit(js.data(), js.accel, jnp.asarray(origins.numpy()),
                           jnp.asarray(dirs.numpy()), jcfg)
    thit = tpipe.trace_hit(ts.data(), ts.accel, origins, dirs, ts.config)
    assert (np.asarray(jhit.face) >= 0).mean() > 0.1
    assert_slots_match(thit.face.numpy(), np.asarray(jhit.face),
                       thit.t.numpy(), np.asarray(jhit.t), max_share=0.01)


# ---------------------------------------------------------------------------
# The rest of trace/shade.py.
# ---------------------------------------------------------------------------


def brute_hit(fields, rays=500, seed=9):
    """JAX oracle hits of seeded rays into `numpy_scene`'s scene, as numpy
    (t, u, v, face) with misses among them."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(rays, 3)) * [0.4, 0.4, 0.0] + [0.0, 0.0, 1.0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.zeros((rays, 3), np.float32)
    h = jax_brute(jnp.asarray(fields["positions"]),
                  jnp.asarray(fields["faces"]), jnp.asarray(o),
                  jnp.asarray(d))
    hit = tuple(np.array(x) for x in (h.t, h.u, h.v, h.face))
    assert 0 < (hit[3] >= 0).sum() < rays
    return o, d, hit


@pytest.mark.parametrize("kind", ["plain", "textured"])
def test_shading_matches_jax(kind):
    fields = numpy_scene(400, seed=29, textured=kind == "textured")
    js, ts = jax_scene(fields), torch_scene(fields)
    o, d, (t, u, v, face) = brute_hit(fields)
    jhit = JaxHit(t=jnp.asarray(t), u=jnp.asarray(u), v=jnp.asarray(v),
                  face=jnp.asarray(face))
    thit = Hit(t=torch.from_numpy(t), u=torch.from_numpy(u),
               v=torch.from_numpy(v), face=torch.from_numpy(face))
    # The packed normal shader: equal values.
    want = np.asarray(jshade.shade_normal_packed(js, jhit))
    got = tshade.shade_normal_packed(ts, thit)
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    # Lambert through the face tables, with a shadow mask.
    shadow = np.random.default_rng(3).random(t.shape) < 0.3
    jt = jshade.build_face_tables(js)
    tt = tshade.build_face_tables(ts)
    assert tt.has_uv == jt.has_uv == (kind == "textured")
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))
    want = np.asarray(jshade.shade_lambert_rgb(
        js, jhit, jnp.asarray(o), jnp.asarray(d),
        shadow_mask=jnp.asarray(shadow), tables=jt))
    got = tshade.shade_lambert_rgb(ts, thit, torch.from_numpy(o),
                                   torch.from_numpy(d),
                                   shadow_mask=torch.from_numpy(shadow),
                                   tables=tt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    generic = tshade.shade_lambert_rgb(ts, thit, torch.from_numpy(o),
                                       torch.from_numpy(d),
                                       shadow_mask=torch.from_numpy(shadow))
    np.testing.assert_allclose(got, generic.numpy(), rtol=0, atol=1e-6)


def test_pack_shaded_matches_jax():
    rgb = np.random.default_rng(4).uniform(-0.1, 1.1, (300, 3)).astype(
        np.float32)
    want = np.asarray(jshade.pack_shaded(jnp.asarray(rgb)))
    got = tshade.pack_shaded(torch.from_numpy(rgb))
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want)
