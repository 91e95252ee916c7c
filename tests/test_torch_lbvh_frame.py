"""`FrameRenderer`'s shadows off the CLUSTER route: on an LBVH (BVH and
WAVEFRONT) the shadow rays walk the tree (`traverse.any_hit_bvh`, kernel
K's any hit), on BRUTE and GRID they run `any_hit_brute` (kernel E); the
mask equals ``any_hit_brute(...) & hit_mask`` bit for bit on every
structure.  The BVH frame is also held against the benchmark's plain
reference (`portbench/reference/render.py`) by the cell's own check.

CPU tests run the kernels' plain versions.  The test marked ``card``
needs an NVIDIA GPU and skips without one; on the card: ``python -m
pytest tests/test_torch_lbvh_frame.py -m card --noconftest`` (this file
imports no jax)."""

from __future__ import annotations

import json
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import checks, traffic
from portbench.reference import render as ref
from portbench.scenes import make_inputs, port_scene, ref_scene, shading
from raytracercuda_torch.config import AccelKind, RenderConfig
from raytracercuda_torch.models.camera import (camera_ray_grid,
                                               orient_from_pan_pitch)
from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
from raytracercuda_torch.models.scene import Material, Scene
from raytracercuda_torch.trace import bruteforce, frame, traverse
from raytracercuda_torch.types import FLT_MAX

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
BENCH_CONFIG = ROOT / "portbench" / "configs" / "bunny69k.bvh512.json"
NEAR = ROOT / "portbench" / "traffic" / "near.json"


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


def sphere_scene(kind: str, case: str):
    """A bumpy sphere ahead of the eye; ``textured`` gives it uvs and a
    texture, ``occluder`` puts a small sphere between it and the light,
    so that lit faces lie in a cast shadow, and one out of view between
    the eye and the light, which the shadow rays of missed pixels (from
    the eye) would hit without ``hit_mask``."""
    config = RenderConfig(accel=getattr(AccelKind, kind))
    scene = Scene(config, device="cpu")
    big = bumpy_sphere_mesh(1500, 1.0, (0.0, 0.0, 3.0), seed=3)
    big.material_id = 0
    scene.add_mesh(big)
    materials = [Material(albedo=(0.8, 0.7, 0.6),
                          texture_id=0 if case == "textured" else -1)]
    if case == "occluder":
        small = bumpy_sphere_mesh(300, 0.3, (0.64, 1.28, 2.28), seed=4)
        small.material_id = 1
        scene.add_mesh(small)
        behind = bumpy_sphere_mesh(300, 0.5, (0.8, 1.6, -0.9), seed=5)
        behind.material_id = 1
        scene.add_mesh(behind)
        materials.append(Material(albedo=(0.3, 0.5, 0.9)))
    scene.materials = materials
    if case == "textured":
        scene.textures = [np.random.default_rng(1).random(
            (8, 8, 3), dtype=np.float32)]
    return config, scene.data(), scene.accel


# (structure, scene, height, width): BVH at 32x32 traces its primary rays
# with the tile beam (L), at 36x28 with the per-ray walk (K).
CASES = [("BVH", "textured", 32, 32), ("BVH", "occluder", 36, 28),
         ("WAVEFRONT", "textured", 32, 32), ("WAVEFRONT", "occluder", 32, 32),
         ("GRID", "occluder", 32, 32), ("BRUTE", "textured", 24, 24)]


@pytest.mark.parametrize("kind,case,height,width", CASES)
def test_shadow_mask_equals_brute_force_on_hit_rays(kind, case, height,
                                                    width, monkeypatch):
    config, data, accel = sphere_scene(kind, case)
    renderer = frame.FrameRenderer(data, accel, config, height, width)
    calls = {"bvh": 0, "brute": 0}
    brute, walk, shade = (bruteforce.any_hit_brute, traverse.any_hit_bvh,
                          frame.shade_lambert_rgb)
    seen = {}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    def shade_seen(scene, hit, origin, dirs, **kw):
        seen.update(hit=hit, origin=origin, dirs=dirs,
                    mask=kw["shadow_mask"])
        return shade(scene, hit, origin, dirs, **kw)

    monkeypatch.setattr(bruteforce, "any_hit_brute", counted("brute", brute))
    monkeypatch.setattr(traverse, "any_hit_bvh", counted("bvh", walk))
    monkeypatch.setattr(frame, "shade_lambert_rgb", shade_seen)
    orient = torch.as_tensor(orient_from_pan_pitch(0.05, -0.03),
                             dtype=torch.float32)
    renderer.render(torch.zeros(3), orient,
                    camera_ray_grid(height, width, device="cpu"))
    lbvh = kind in ("BVH", "WAVEFRONT")
    assert calls == {"bvh": int(lbvh), "brute": int(not lbvh)}

    hit, origin, dirs = seen["hit"], seen["origin"], seen["dirs"]
    p = origin + dirs * torch.clamp(hit.t, max=1e6)[..., None]
    so = (torch.where(hit.hit_mask[..., None], p, origin)
          + renderer.light * renderer.shadow_eps)
    want = brute(data.positions, data.faces, so,
                 renderer.light.expand(dirs.shape), float(FLT_MAX),
                 config.trace) & hit.hit_mask
    got = seen["mask"]
    assert got.dtype == torch.bool and torch.equal(got, want)
    # The case holds what it should: missed rays, and hit rays in shadow.
    assert (~hit.hit_mask).any() and want.any()
    if case == "occluder":  # missed rays whose shadow rays are blocked
        unmasked = brute(data.positions, data.faces, so,
                         renderer.light.expand(dirs.shape), float(FLT_MAX),
                         config.trace)
        assert (unmasked & ~hit.hit_mask).any()


def bench_case(faces: int, side: int, seed: int):
    """The bunny69k.bvh512 configuration with ``faces`` triangles at
    ``side``², its inputs for ``seed``, the program's renderer and the
    near traffic's poses."""
    config = json.loads(BENCH_CONFIG.read_text())
    config["meshes"][0]["faces"] = faces
    config["width"] = config["height"] = side
    inputs = make_inputs(config, seed)
    rcfg, scene = port_scene(inputs, config, "cpu")
    assert rcfg.accel == AccelKind.BVH
    sh = shading(config)
    renderer = frame.FrameRenderer(
        scene.data(), scene.accel, rcfg, side, side, light_dir=sh.light,
        ambient=sh.ambient, background=sh.background,
        shadows=config["shadows"])
    pos = inputs.meshes[0]["positions"]
    lo, hi = pos.min(0), pos.max(0)
    eyes, orients = traffic.orbit(json.loads(NEAR.read_text()),
                                  (lo + hi) / 2,
                                  config["meshes"][0]["radius"],
                                  float((hi - lo).max()))
    return config, inputs, sh, renderer, eyes, orients


def test_bvh_frame_matches_the_plain_reference():
    """The cell's check (`checks.frame_px_off` within its limit) on the
    BVH route at 48x48 over 2,000 faces, at four poses of the near
    orbit."""
    side = 48
    config, inputs, sh, renderer, eyes, orients = bench_case(
        2000, side, 2 ** 31 + 12345)
    limit = json.loads((ROOT / "portbench" / "limits" /
                        "bunny69k.bvh512.near.json").read_text())["px_off"]
    scene = ref_scene(inputs, "cpu")
    rays = ref.camera_rays(side, side)
    for k in (0, 50, 130, 200):
        eye = torch.from_numpy(eyes[k])
        orient = torch.from_numpy(orients[k])
        got = renderer.render(eye, orient, rays)
        want = ref.render_frame(scene, eye, orient, rays, side, side, sh,
                                config["shadows"], torch.float32)
        bg = int(ref.pack(torch.tensor([sh.background]))[0])
        assert (got.to(torch.int64) != bg).any()
        assert checks.frame_px_off(got, want) <= limit


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.card
def test_lbvh_shadow_mask_over_the_near_period(monkeypatch):
    """At the cell's size (69,451 faces, 512x512), every pose of the near
    orbit: kernel K's mask against E's ``any_hit_brute(...) & hit_mask``
    on the card, bit for bit.  Prints the differing bits."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    from raytracercuda_torch.ops import cuda_build

    cuda_build.load_library()
    config = json.loads(BENCH_CONFIG.read_text())
    side = config["width"]
    inputs = make_inputs(config, 2 ** 31 + 12345)
    rcfg, scene = port_scene(inputs, config, torch.device("cuda", 0))
    renderer = frame.FrameRenderer(
        scene.data(), scene.accel, rcfg, side, side,
        light_dir=config["light_dir"], ambient=config["ambient"],
        background=config["background"], shadows=True)
    pos = inputs.meshes[0]["positions"]
    lo, hi = pos.min(0), pos.max(0)
    eyes, orients = traffic.orbit(json.loads(NEAR.read_text()),
                                  (lo + hi) / 2,
                                  config["meshes"][0]["radius"],
                                  float((hi - lo).max()))
    rays = ref.camera_rays(side, side, device="cuda")
    data = renderer.scene
    brute = bruteforce.any_hit_brute
    seen = {}
    shade = frame.shade_lambert_rgb

    def shade_seen(scene_, hit, origin, dirs, **kw):
        seen.update(hit=hit, origin=origin, dirs=dirs,
                    mask=kw["shadow_mask"])
        return shade(scene_, hit, origin, dirs, **kw)

    monkeypatch.setattr(frame, "shade_lambert_rgb", shade_seen)
    differ, occluded = [], 0
    for k in range(len(eyes)):
        renderer.render(torch.from_numpy(eyes[k]).cuda(),
                        torch.from_numpy(orients[k]).cuda(), rays)
        hit, origin, dirs = seen["hit"], seen["origin"], seen["dirs"]
        p = origin + dirs * torch.clamp(hit.t, max=1e6)[..., None]
        so = (torch.where(hit.hit_mask[..., None], p, origin)
              + renderer.light * renderer.shadow_eps)
        want = brute(data.positions, data.faces, so,
                     renderer.light.expand(dirs.shape), float(FLT_MAX),
                     rcfg.trace) & hit.hit_mask
        bad = torch.nonzero(seen["mask"] != want).flatten().tolist()
        differ += [(k, i) for i in bad]
        occluded += int(want.sum())
    print(f"LBVH shadow mask over {len(eyes)} poses: {len(differ)} differing "
          f"bits of {len(eyes) * side * side}, {occluded} occluded; "
          f"first differing (pose, pixel): {differ[:20]}")
    assert occluded > 0 and differ == []
