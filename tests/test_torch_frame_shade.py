"""The CLUSTER frame's two shading phases (`trace/shade.py`:
`shadow_setup` after kernel A, `frame_shade` after kernel B), one kernel
launch each on the card (`csrc/frame.cu`: `shadow_setup_kernel`,
`frame_shade_kernel`) in place of the PyTorch chain of
`FrameRenderer._shadow_shade` (~110 launches a frame).

On the CPU: the factored plain phases give frames bit-equal to that chain
(`chain_frame`, kept here as it ran) with and without a texture and
shadows, and with another background and ambient; a numpy replay of the
kernels' per-pixel arithmetic, in their operation order, is bit-equal to
the plain phases on a frame's planes and on edge cases (wrapped and
negative uvs, texture ids out of the atlas, degenerate normals, far and
missed hits); `FrameRenderer` on CPU tensors runs the plain phases; the
CUDA wrappers refuse CPU tensors; with counting stand-ins for the kernels
a frame launches each once, inside ``frame.shadow_rays`` and
``frame.shade``, and its spans keep their tree.

The tests marked ``card`` need an NVIDIA GPU and skip without one; on the
card: ``python -m pytest tests/test_torch_frame_shade.py -m card -s
--noconftest`` (this file imports no jax).  There the kernels' frames are
bit-equal to the plain phases' over every pose of the near and far orbits
of bunny69k.c512 and on an untextured and an unshadowed frame, each frame
counts one launch of each kernel, inside its span, and a frame launches
at least 90 fewer kernels than the chain's route."""

from __future__ import annotations

import contextlib
import signal

import numpy as np
import pytest
import torch

from raytracercuda_torch.config import AccelKind, RenderConfig
from raytracercuda_torch.models.camera import (camera_ray_grid,
                                               orient_from_pan_pitch)
from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
from raytracercuda_torch.models.scene import Material, Scene
from raytracercuda_torch.ops.math import pack_rgb
from raytracercuda_torch.trace import shade
from raytracercuda_torch.trace.dense import untile_pixels
from raytracercuda_torch.trace.frame import FrameRenderer
from raytracercuda_torch.trace.shade import (faced_ndotl_planar,
                                             lambert_planar,
                                             shadow_origins_planar)
from raytracercuda_torch.trace.sweep import occlusion_tiles_planar
from raytracercuda_torch.types import FLT_MAX
from raytracercuda_torch.utils import profiler
from raytracercuda_torch.utils.profiler import collect, tracing

torch.set_num_threads(1)
CONFIG = RenderConfig(accel=AccelKind.CLUSTER)
TP = 16
#: The light `FrameRenderer` defaults to, and a point two radii from the
#: sphere's centre toward it, where a small sphere casts a shadow on it.
LIGHT = np.array([0.4, 0.8, -0.45])
SHADOWER = (0.0, 0.0, 3.0) + 1.6 * LIGHT / np.linalg.norm(LIGHT)


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


def small_scene(textured: bool, device="cpu", faces=800):
    """A bumpy sphere and a small one between it and the light, textured
    (an 8x5 texture: rows and columns differ) or not; ``(data,
    clusters)``."""
    scene = Scene(CONFIG, device=device)
    for n, radius, centre, material in (
            (faces, 1.0, (0.0, 0.0, 3.0), 0),
            (max(faces // 4, 48), 0.3, tuple(SHADOWER), 1)):
        mesh = bumpy_sphere_mesh(n, radius, centre, seed=3)
        mesh.material_id = material
        scene.add_mesh(mesh)
    tex = 0 if textured else -1
    scene.materials = [Material(albedo=(0.8, 0.7, 0.6), texture_id=tex),
                       Material(albedo=(0.3, 0.9, 0.5), texture_id=tex)]
    if textured:
        scene.textures = [np.random.default_rng(1).random(
            (8, 5, 3), dtype=np.float32)]
    return scene.data(), scene.accel


def pose(device="cpu"):
    eye = torch.tensor([0.1, 0.2, 0.0], device=device)
    orient = torch.as_tensor(orient_from_pan_pitch(0.05, 0.1),
                             dtype=torch.float32, device=device)
    return eye, orient


def chain_frame(renderer, eye, orient, rays):
    """The frame through the chain `FrameRenderer._shadow_shade` ran before
    its two phases were factored out, op for op."""
    eye, orient = eye.to(torch.float32), orient.to(torch.float32)
    d3_tiles, outs = renderer._trace(eye, orient, rays)
    tp = renderer.tile_px
    t = d3_tiles.shape[0]
    hitm, _, _, _, ndotl = faced_ndotl_planar(outs, d3_tiles, renderer.light)
    if renderer.shadows:
        active = (hitm & (ndotl > 0.0)).reshape(t, tp * tp)
        o3 = shadow_origins_planar(eye, d3_tiles, outs[0], active,
                                   renderer.light, renderer.shadow_eps)
        shadow = occlusion_tiles_planar(
            renderer.accel, o3, renderer.light, active, tile_px=tp,
            trace_cfg=renderer.config.trace)
        ndotl = torch.where(shadow.reshape(-1), 0.0, ndotl)
    r, g, b = lambert_planar(outs, ndotl, renderer.scene.textures,
                             renderer.has_uv, renderer.ambient)
    bg = renderer.background
    packed = pack_rgb(torch.where(hitm, r, bg[0]),
                      torch.where(hitm, g, bg[1]),
                      torch.where(hitm, b, bg[2]))
    return untile_pixels(packed.reshape(t, tp * tp), renderer.height,
                         renderer.width, tp)


#: (textured, shadows, renderer keywords) of the CPU frames.
CASES = {
    "textured_shadowed": (True, True, {}),
    "untextured_shadowed": (False, True, {}),
    "textured_unshadowed": (True, False, {}),
    "other_background_and_ambient": (
        True, True, {"background": (0.2, 0.35, 0.9), "ambient": 0.3}),
}


def renderer_of(case: str, height=32, width=48, device="cpu"):
    textured, shadows, kw = CASES[case]
    data, accel = small_scene(textured, device)
    return FrameRenderer(data, accel, CONFIG, height, width,
                         shadows=shadows, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_phases_equal_the_chain(case):
    """A 48x32 frame (3x2 tiles) through `FrameRenderer` and through the
    chain it replaced: the same bits; shadows and the texture change it."""
    r = renderer_of(case)
    eye, orient = pose()
    rays = camera_ray_grid(r.width, r.height, device="cpu")
    got = r.render(eye, orient, rays)
    want = chain_frame(r, eye, orient, rays)
    assert got.dtype == torch.uint32 and got.shape == (r.height * r.width,)
    assert torch.equal(got, want)
    assert len(torch.unique(got.to(torch.int64))) > 20
    textured, shadows, kw = CASES[case]
    other = FrameRenderer(r.scene, r.accel, CONFIG, r.height, r.width,
                          shadows=not shadows, **kw)
    assert not torch.equal(got, other.render(eye, orient, rays))
    if textured:
        flat = FrameRenderer(r.scene._replace(
            textures=torch.ones_like(r.scene.textures)), r.accel, CONFIG,
            r.height, r.width, shadows=shadows, **kw)
        assert not torch.equal(got, flat.render(eye, orient, rays))


@contextlib.contextmanager
def counted_phases(monkeypatch, as_kernels: bool):
    """Count the calls of the plain phases, and record the innermost span
    open at each; ``as_kernels``: `shade._pick` picks the CUDA wrappers,
    and they run the plain phases and count a launch."""
    calls = {"shadow_setup": [], "frame_shade": []}
    for key in calls:
        plain = getattr(shade, f"_{key}_plain")

        def run(*args, key=key, plain=plain):
            stack = getattr(profiler._local, "stack", [])
            calls[key].append(stack[-1].name if stack else None)
            if as_kernels:
                shade.launch_counts[key] += 1
            return plain(*args)

        monkeypatch.setattr(shade, f"_{key}_cuda" if as_kernels
                            else f"_{key}_plain", run)
    if as_kernels:
        monkeypatch.setattr(shade, "_pick", lambda x, plain, cuda: cuda)
    shade.reset_launch_counts()
    yield calls


def test_cpu_frames_run_the_plain_phases(monkeypatch):
    r = renderer_of("textured_shadowed")
    eye, orient = pose()
    rays = camera_ray_grid(r.width, r.height, device="cpu")
    with counted_phases(monkeypatch, as_kernels=False) as calls:
        r.render(eye, orient, rays)
    assert {k: len(v) for k, v in calls.items()} == {"shadow_setup": 1,
                                                     "frame_shade": 1}
    assert shade.launch_counts == {"shadow_setup": 0, "frame_shade": 0}


FRAME_TREE = [(0, "frame"), (1, "frame.rays"), (1, "sweep.cull"),
              (2, "sync.tile_lists"), (1, "sweep.A"),
              (1, "frame.shadow_rays"), (1, "sweep.shadow_cull"),
              (2, "sync.tile_lists"), (1, "sweep.B"), (1, "frame.shade")]
UNSHADOWED_TREE = FRAME_TREE[:6] + [(1, "frame.shade")]


def span_tree(record) -> list:
    by_id = {s.id: s for s in record.spans}

    def depth(s):
        d = 0
        while s.parent is not None:
            s, d = by_id[s.parent], d + 1
        return d

    return [(depth(s), s.name)
            for s in sorted(record.spans, key=lambda s: (s.start_ns, s.id))]


@pytest.mark.parametrize("shadows", [True, False])
def test_kernel_route_launches_each_once_inside_its_span(monkeypatch,
                                                         shadows):
    """With the wrappers picked as on the card (their kernels stood in for
    by the plain phases): one launch of each a frame, in its span, the
    frame's spans in their tree and its bits unchanged."""
    r = renderer_of("textured_shadowed" if shadows else "textured_unshadowed")
    eye, orient = pose()
    rays = camera_ray_grid(r.width, r.height, device="cpu")
    want = r.render(eye, orient, rays)
    collect()
    with counted_phases(monkeypatch, as_kernels=True) as calls:
        with tracing():
            got = r.render(eye, orient, rays)
    record = collect()
    assert calls == {"shadow_setup": ["frame.shadow_rays"],
                     "frame_shade": ["frame.shade"]}
    assert shade.launch_counts == {"shadow_setup": 1, "frame_shade": 1}
    assert span_tree(record) == (FRAME_TREE if shadows
                                 else UNSHADOWED_TREE)
    assert torch.equal(got, want)


def frame_planes(case: str):
    """A 48x32 frame's ``(renderer, eye, d3_tiles, outs)``: kernel A's
    planar outputs as the phases read them."""
    r = renderer_of(case)
    eye, orient = pose()
    rays = camera_ray_grid(r.width, r.height, device="cpu")
    d3_tiles, outs = r._trace(eye, orient, rays)
    return r, eye, d3_tiles, outs


def test_cuda_wrappers_reject_cpu_tensors():
    r, eye, d3_tiles, outs = frame_planes("textured_shadowed")
    with pytest.raises(ValueError, match="CUDA"):
        shade._shadow_setup_cuda(outs, d3_tiles, eye, r.light, r.shadow_eps,
                                 True)
    ndotl, active, o3 = shade._shadow_setup_plain(
        outs, d3_tiles, eye, r.light, r.shadow_eps, True)
    for shadow in (active, None):
        with pytest.raises(ValueError, match="CUDA"):
            shade._frame_shade_cuda(outs, ndotl, shadow, r.scene.textures,
                                    r.has_uv, r.ambient, r.background,
                                    r.height, r.width, TP)
    with pytest.raises(ValueError, match="tiles"):
        shade._frame_shade_cuda(outs, ndotl, None, r.scene.textures,
                                r.has_uv, r.ambient, r.background,
                                r.width, r.height + TP, TP)


# ---------------------------------------------------------------------------
# The kernels' arithmetic replayed in numpy float32.
# ---------------------------------------------------------------------------

F32 = np.float32


def _clamp_min(x, lo):
    return np.where(np.isnan(x), x, np.fmax(x, F32(lo)))


def replay_setup(t, nx, ny, nz, d3, eye, light, eps, shadows: bool):
    """`shadow_setup_kernel` over every pixel at once, in its operation
    order: ``(ndotl, active, o3)`` as numpy float32 and bool arrays."""
    tiles, _, r = d3.shape
    d = [d3[:, c, :].reshape(-1) for c in range(3)]
    x, y, z = (a.reshape(-1) for a in (nx, ny, nz))
    length = np.sqrt(_clamp_min(x * x + y * y + z * z, 1e-30))
    x, y, z = x / length, y / length, z / length
    flip = x * d[0] + y * d[1] + z * d[2] > F32(0)
    x, y, z = (np.where(flip, -a, a) for a in (x, y, z))
    nl = _clamp_min(x * light[0] + y * light[1] + z * light[2], 0.0)
    if not shadows:
        return nl, None, None
    tt = t.reshape(-1)
    act = (tt < FLT_MAX) & (nl > F32(0))
    tmin = np.where(np.isnan(tt), tt, np.fmin(tt, F32(1e6)))
    o3 = np.stack([(np.where(act, eye[c] + d[c] * tmin, eye[c])
                    + light[c] * eps).reshape(tiles, r) for c in range(3)],
                  axis=1)
    return nl, act.reshape(tiles, r), o3


def _wrap_unit(x):
    m = np.fmod(x, F32(1))
    return np.where((m != 0) & (m < 0), m + F32(1), m)


def _to_u8(x):
    y = x * F32(255)
    y = np.where(np.isnan(y), F32(0), np.fmin(np.fmax(y, F32(0)), F32(255)))
    return y.astype(np.int32).astype(np.uint32)


def replay_shade(t, ndotl, shadow, albedo, texplanes, textures, ambient,
                 background, height, width, tile_px):
    """`frame_shade_kernel` over every pixel at once, in its operation
    order: the row-major ``[H*W]`` uint32 frame.  ``texplanes``: (id, u,
    v) planes, or None untextured."""
    hit = t.reshape(-1) < FLT_MAX
    nl = ndotl if shadow is None else np.where(shadow.reshape(-1), F32(0),
                                               ndotl)
    rgb = [a.reshape(-1) for a in albedo]
    if texplanes is not None:
        n, h, w = textures.shape[:3]
        tid = texplanes[0].reshape(-1).astype(np.int32)
        fu = _wrap_unit(texplanes[1].reshape(-1)) * F32(w - 1)
        fv = _wrap_unit(texplanes[2].reshape(-1)) * F32(h - 1)
        x0 = np.floor(fu).astype(np.int64)
        y0 = np.floor(fv).astype(np.int64)
        x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
        ax, ay = fu - x0.astype(F32), fv - y0.astype(F32)
        k = np.clip(tid, 0, n - 1)
        for c in range(3):
            tex = textures[..., c]
            top = tex[k, y0, x0] * (F32(1) - ax) + tex[k, y0, x1] * ax
            bot = tex[k, y1, x0] * (F32(1) - ax) + tex[k, y1, x1] * ax
            rgb[c] = np.where(tid >= 0, rgb[c] * (top * (F32(1) - ay)
                                                  + bot * ay), rgb[c])
    lit = F32(ambient) + F32(1.0 - ambient) * nl
    rgb = [np.where(hit, a * lit, F32(bg)) for a, bg in zip(rgb, background)]
    packed = (_to_u8(rgb[0]) << 16) | (_to_u8(rgb[1]) << 8) | _to_u8(rgb[2])
    th, tw = height // tile_px, width // tile_px
    return (packed.reshape(th, tw, tile_px, tile_px).transpose(0, 2, 1, 3)
            .reshape(-1))


def edge_planes(outs, seed=0):
    """``outs`` with edge cases written over a few pixels: uvs far
    outside [0, 1), negative, a hair below an integer (the wrap's sum
    rounds to 1.0) and whole; texture ids -1 and past the atlas; zero
    and tiny normals; hits beyond 1e6 and at FLT_MAX.  (No NaN: the CPU
    casts it to int32 as INT_MIN, the card as 0.)"""
    rng = np.random.default_rng(seed)
    outs = [o.clone() for o in outs]
    n = outs[0].numel()
    pick = torch.from_numpy(rng.choice(n, 64, replace=False))
    u = torch.tensor([-3.25, -1e-9, 2.0, 7.999999, -0.5, 1e5, -1e-30, 0.0]
                     * 8)
    for plane, values in ((11, u), (12, u.flip(0)),
                          (10, torch.tensor([-1.0, 0.0, 5.0, 1.0] * 16))):
        outs[plane].view(-1)[pick] = values
    zero, tiny = pick[:4], pick[4:8]
    for plane in (4, 5, 6):
        outs[plane].view(-1)[zero] = 0.0
        outs[plane].view(-1)[tiny] = 1e-20
    outs[0].view(-1)[pick[10:14]] = 3e6
    outs[0].view(-1)[pick[14:18]] = float(FLT_MAX)
    return outs


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("case", ["textured_shadowed",
                                  "other_background_and_ambient",
                                  "untextured_shadowed"])
def test_kernel_arithmetic_replayed_equals_plain_phases(case, edges):
    r, eye, d3_tiles, outs = frame_planes(case)
    if edges:
        outs = edge_planes(outs)
    ndotl, active, o3 = shade._shadow_setup_plain(
        outs, d3_tiles, eye, r.light, r.shadow_eps, True)
    np_ = [o.numpy() for o in outs]
    nl, act, o = replay_setup(np_[0], *np_[4:7], d3_tiles.numpy(),
                              eye.numpy(), r.light.numpy(),
                              r.shadow_eps.numpy(), True)
    assert np.array_equal(nl, ndotl.numpy())
    assert np.array_equal(act, active.numpy()) and act.any()
    assert np.array_equal(o.view(np.int32), o3.numpy().view(np.int32))
    shadow = torch.from_numpy(np.random.default_rng(2).random(
        active.shape) < 0.3) & active
    got = shade._frame_shade_plain(outs, ndotl, shadow, r.scene.textures,
                                   r.has_uv, r.ambient, r.background,
                                   r.height, r.width, TP)
    # A scene without textures has a 1x1 atlas: its ids of -1 skip it.
    textured = shade._textured(r.scene.textures, r.has_uv)
    want = replay_shade(np_[0], nl, shadow.numpy(), np_[7:10],
                        np_[10:13] if textured else None,
                        r.scene.textures.numpy(), r.ambient, r.background,
                        r.height, r.width, TP)
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                          want)


def test_replayed_setup_without_shadows_writes_only_ndotl():
    r, eye, d3_tiles, outs = frame_planes("textured_unshadowed")
    ndotl, active, o3 = shade._shadow_setup_plain(
        outs, d3_tiles, eye, r.light, r.shadow_eps, False)
    assert active is None and o3 is None
    np_ = [o.numpy() for o in outs]
    nl, act, o = replay_setup(np_[0], *np_[4:7], d3_tiles.numpy(),
                              eye.numpy(), r.light.numpy(),
                              r.shadow_eps.numpy(), False)
    assert act is None and o is None
    assert np.array_equal(nl, ndotl.numpy())


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    from raytracercuda_torch.ops import cuda_build

    cuda_build.load_library()
    return torch.device("cuda", 0)


@contextlib.contextmanager
def plain_phases():
    """Within it, the phases' CUDA wrappers run the plain chains."""
    saved = shade._shadow_setup_cuda, shade._frame_shade_cuda
    shade._shadow_setup_cuda = shade._shadow_setup_plain
    shade._frame_shade_cuda = shade._frame_shade_plain
    try:
        yield
    finally:
        shade._shadow_setup_cuda, shade._frame_shade_cuda = saved


@pytest.mark.card
@pytest.mark.parametrize("traffic", ["near", "far"])
def test_frames_over_the_period_equal_the_plain_phases(traffic):
    """bunny69k.c512 (69,451 faces, 512x512, 1,024 tiles): every pose of
    the traffic's 240-frame orbit through the kernels and through the
    plain phases on the card, bit for bit; one launch of each kernel a
    frame."""
    from test_torch_cull import config_scene, orbit

    dev = _card()
    config, data, accel = config_scene("bunny69k.c512", dev)
    w, h = config["width"], config["height"]
    renderer = FrameRenderer(data, accel, CONFIG, h, w)
    rays = camera_ray_grid(w, h, device=dev)
    pos = data.positions.cpu().numpy()
    lo, hi = pos.min(0), pos.max(0)
    poses = list(orbit(traffic, (lo + hi) / 2, config["meshes"][0]["radius"],
                       float((hi - lo).max())))
    differ = []
    shade.reset_launch_counts()
    for k, (eye, orient) in enumerate(poses):
        eye, orient = (torch.as_tensor(x, device=dev) for x in (eye, orient))
        got = renderer.render(eye, orient, rays)
        with plain_phases():
            want = renderer.render(eye, orient, rays)
        if not torch.equal(got, want):
            differ.append(k)
    torch.cuda.synchronize()
    print(f"{traffic}: {len(poses)} frames, not bit-equal: {differ}; "
          f"launches {shade.launch_counts}")
    assert differ == []
    assert shade.launch_counts == {"shadow_setup": len(poses),
                                   "frame_shade": len(poses)}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CASES))
def test_small_frames_equal_the_plain_phases(case):
    """The CPU cases at 512x256 on the card: an untextured frame, an
    unshadowed one, another background and ambient."""
    dev = _card()
    r = renderer_of(case, 256, 512, dev)
    eye, orient = pose(dev)
    rays = camera_ray_grid(r.width, r.height, device=dev)
    shade.reset_launch_counts()
    got = r.render(eye, orient, rays)
    assert shade.launch_counts == {"shadow_setup": 1, "frame_shade": 1}
    with plain_phases():
        want = r.render(eye, orient, rays)
    assert torch.equal(got, want)
    assert torch.equal(chain_frame(r, eye, orient, rays), want)


@pytest.fixture(scope="module")
def bench_sized():
    dev = _card()
    data, accel = small_scene(True, dev, faces=69451)
    r = FrameRenderer(data, accel, CONFIG, 512, 512)
    eye, orient = pose(dev)
    return r, eye, orient, camera_ray_grid(512, 512, device=dev)


@pytest.mark.card
def test_kernels_launch_inside_their_spans(bench_sized, monkeypatch):
    r, eye, orient, rays = bench_sized
    sites = {"shadow_setup": [], "frame_shade": []}
    for key in sites:
        real = getattr(shade, f"_{key}_cuda")

        def run(*args, key=key, real=real):
            stack = getattr(profiler._local, "stack", [])
            sites[key].append(stack[-1].name if stack else None)
            return real(*args)

        monkeypatch.setattr(shade, f"_{key}_cuda", run)
    collect()
    with tracing():
        r.render(eye, orient, rays)
    torch.cuda.synchronize()
    assert span_tree(collect()) == FRAME_TREE
    assert sites == {"shadow_setup": ["frame.shadow_rays"],
                     "frame_shade": ["frame.shade"]}


def _device_activities(run) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.device_type() == DeviceType.CUDA
               for e in prof.profiler.kineto_results.events())


@pytest.mark.card
def test_a_frame_launches_90_fewer_kernels_than_the_chain(bench_sized):
    r, eye, orient, rays = bench_sized
    got = _device_activities(lambda: r.render(eye, orient, rays))
    with plain_phases():
        chain = _device_activities(lambda: r.render(eye, orient, rays))
    print(f"device activities a frame: kernels {got}, chain {chain}")
    assert chain - got >= 90
