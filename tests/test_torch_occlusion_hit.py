"""`pipeline.occlusion_hit`, the any-hit counterpart of `trace_hit`, on
every structure against ``any_hit_brute(...) & active`` (kernel E's plain
version), and the two shadow-origin rules, `pipeline.shadow_origins`
(row-major) and `shade.shadow_origins_planar` (planar tiles), against
each other.

Every case holds inactive rays whose shadow rays are blocked: the mask
must be false there.  CPU tests run the kernels' plain versions; this file
imports no jax."""

from __future__ import annotations

import signal

import numpy as np
import pytest
import torch

from raytracercuda_torch.config import AccelKind, RenderConfig
from raytracercuda_torch.models.camera import (camera_ray_grid,
                                               orient_from_pan_pitch)
from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
from raytracercuda_torch.models.scene import Material, Scene
from raytracercuda_torch.ops.math import normalize
from raytracercuda_torch.trace import bruteforce
from raytracercuda_torch.trace.dense import (tile_pixels, tile_pixels_planar,
                                             untile_pixels)
from raytracercuda_torch.trace.pipeline import (occlusion_hit, rotate_rays,
                                                shadow_origins, trace_hit)
from raytracercuda_torch.trace.shade import shadow_origins_planar
from raytracercuda_torch.types import FLT_MAX

torch.set_num_threads(1)
LIGHT = (0.4, 0.8, -0.45)


@pytest.fixture(autouse=True)
def time_limit():
    """Each test within 120 s (SIGALRM)."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its limit of 120 s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, 120.0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def occluded_scene(kind: str):
    """A bumpy sphere ahead of the eye, a small one between it and the
    light (so lit faces lie in a cast shadow), and one out of view
    between the eye and the light (so the shadow rays of missed pixels,
    from the eye, are blocked)."""
    config = RenderConfig(accel=getattr(AccelKind, kind))
    scene = Scene(config, device="cpu")
    for i, (faces, radius, centre, seed) in enumerate((
            (1500, 1.0, (0.0, 0.0, 3.0), 3),
            (300, 0.3, (0.64, 1.28, 2.28), 4),
            (300, 0.5, (0.8, 1.6, -0.9), 5))):
        mesh = bumpy_sphere_mesh(faces, radius, centre, seed=seed)
        mesh.material_id = min(i, 1)
        scene.add_mesh(mesh)
    scene.materials = [Material(albedo=(0.8, 0.7, 0.6)),
                       Material(albedo=(0.3, 0.5, 0.9))]
    return config, scene.data(), scene.accel


def shadow_rays(config, data, accel, height, width):
    """Shadow-ray origins (the gradient route's rule) of a pinhole frame
    from the origin, the unit light, and an active mask that drops every
    third hit ray besides the missed ones."""
    orient = torch.as_tensor(orient_from_pan_pitch(0.05, -0.03),
                             dtype=torch.float32)
    dirs = rotate_rays(camera_ray_grid(height, width, device="cpu"), orient)
    eye = torch.zeros(3)
    origin = eye[None, :].expand(dirs.shape)
    hit = trace_hit(data, accel, origin, dirs, config,
                    frame_hw=(height, width), common_origin=eye)
    light = normalize(torch.tensor(LIGHT))
    so = shadow_origins(origin, dirs, hit.t, hit.hit_mask, light,
                        10 * config.trace.t_epsilon, 1e6)
    keep = torch.arange(dirs.shape[0]) % 3 != 0
    return so, light, hit.hit_mask & keep


# (structure, height, width, frame): CLUSTER at 32x32 is a frame the
# 16-pixel tile divides, at 20x24 one it does not (edge-padded), and
# without frame_hw a bundle of 480 rays in groups of one tile's count.
CASES = [("BRUTE", 24, 24, True), ("BVH", 24, 24, True),
         ("WAVEFRONT", 24, 24, True), ("GRID", 24, 24, True),
         ("CLUSTER", 32, 32, True), ("CLUSTER", 20, 24, True),
         ("CLUSTER", 20, 24, False)]


@pytest.mark.parametrize("kind,height,width,frame", CASES)
def test_occlusion_hit_equals_brute_force_on_active_rays(kind, height,
                                                         width, frame):
    config, data, accel = occluded_scene(kind)
    so, light, active = shadow_rays(config, data, accel, height, width)
    got = occlusion_hit(data, accel, so, light, active, config,
                        frame_hw=(height, width) if frame else None)
    unmasked = bruteforce.any_hit_brute(
        data.positions, data.faces, so, light.expand(so.shape),
        float(FLT_MAX), config.trace)
    want = unmasked & active
    assert got.dtype == torch.bool and got.shape == active.shape
    assert torch.equal(got, want)
    # The case holds what it should: occluded active rays, and inactive
    # rays that would be occluded.
    assert want.any() and (unmasked & ~active).any()


def test_shadow_origins_planar_untiled_equals_row_major():
    """The planar rule on tiles, untiled, is the row-major rule with the
    1e6 clamp, bit for bit, on the same rays."""
    height, width, tp = 32, 48, 16
    g = torch.Generator().manual_seed(7)
    dirs = normalize(torch.randn(height * width, 3, generator=g))
    t = torch.rand(height * width, generator=g) * 4.0
    t[::5] = float(FLT_MAX)  # misses
    active = (t < FLT_MAX) & (torch.rand(height * width, generator=g) > 0.3)
    active[::10] = True  # active misses take the clamped point
    eye = torch.tensor([0.25, -0.5, 1.5])
    light = normalize(torch.tensor(LIGHT))
    eps = torch.tensor(np.float32(3e-4))

    want = shadow_origins(eye[None, :].expand(dirs.shape), dirs, t, active,
                          light, eps, 1e6)
    got = shadow_origins_planar(
        eye, tile_pixels_planar(dirs.T, height, width, tp),
        tile_pixels(t, height, width, tp),
        tile_pixels(active, height, width, tp), light, eps)
    assert got.shape == (height * width // (tp * tp), 3, tp * tp)
    rows = untile_pixels(got.transpose(1, 2), height, width, tp)
    assert torch.equal(rows.contiguous().view(torch.int32),
                       want.view(torch.int32))
