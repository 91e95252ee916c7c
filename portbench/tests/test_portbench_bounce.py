"""The mirror-bounce cell (`kinds.BounceOrbit`, `reference/bounce.py`,
`bounce_roofline.py` and its readers) on the CPU: the reference against
the program's bounce entry, the pixel sample, the control, the faults,
the readers on a synthetic profile, and the inputs that the reflectivity
leaves as they were."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from conftest import CPU, ROOT, run_small, small_cell
from portbench import bounce_roofline, checks, harness, scenes, tracing
from portbench import traffic as gen
from portbench.faults import FAULTS, planted
from portbench.kinds import KINDS
from portbench.reference import bounce, render
from portbench.yardstick import MT_OPS, bound, nbytes

CELL = "multimesh515k.c1080.bounce2"


@pytest.mark.parametrize("width,height,pose", [(64, 48, 0), (64, 48, 20),
                                               (64, 40, 50), (64, 40, 90)])
def test_bounces_equal_the_programs(width, height, pose):
    """Two bounces, every pixel sampled: the program's CPU route of
    `render_bounces` (kernels A, B and F in their plain versions, and the
    edge padding where the tile does not divide the rows) reads what the
    reference reads, with bounces that change pixels."""
    from raytracercuda_torch.trace.bounce import render_bounces
    from raytracercuda_torch.trace.pipeline import rotate_rays
    from raytracercuda_torch.trace.shade import pack_shaded

    cell = harness.load_cell(CELL, ROOT)
    config = copy.deepcopy(cell.config)
    config.update(width=width, height=height)
    for mesh, n in zip(config["meshes"], (600, 3000, 1500)):
        mesh["faces"] = n
    inputs = scenes.make_inputs(config, 3)
    rcfg, scene = scenes.port_scene(inputs, config, CPU)
    sh = scenes.shading(config)
    pos = np.concatenate([m["positions"] for m in inputs.meshes])
    eyes, orients = gen.orbit(cell.traffic, (pos.min(0) + pos.max(0)) / 2,
                              1.0, float((pos.max(0) - pos.min(0)).max()))
    eye, orient = torch.tensor(eyes[pose]), torch.tensor(orients[pose])
    rays = render.camera_rays(width, height)
    got = pack_shaded(render_bounces(
        scene.accel, scene.data(), eye, rotate_rays(rays, orient), height,
        width, rcfg, num_bounces=2, light_dir=sh.light, with_shadows=True,
        background=sh.background))
    every = torch.arange(width * height)
    want, flat = bounce.render_sample(scenes.ref_scene(inputs, CPU), eye,
                                      orient, rays, width, height, sh, True,
                                      2, every)
    assert int((want != flat).sum()) > 0  # the bounces change pixels
    assert checks.frame_px_off(got, want) == 0.0


def test_the_push_is_the_programs_cluster_box_rule():
    """``t_eps * max(max(positions) - min(positions), 1)`` equals the
    program's ``t_eps * max(max(cmax) - min(cmin), 1)``: bit for bit on a
    small scene, and on the configuration's own meshes every vertex that
    sets the spread is a face's."""
    cell = small_cell(CELL)
    inputs = scenes.make_inputs(cell.config, 3)
    _, scene = scenes.port_scene(inputs, cell.config, CPU)
    cs = scene.accel
    theirs = torch.tensor(1e-4, dtype=torch.float32) * torch.clamp(
        cs.cmax.max() - cs.cmin.min(), min=1.0)
    ref = scenes.ref_scene(inputs, CPU)
    assert torch.equal(bounce.push(ref, 1e-4), theirs)

    full = scenes.make_inputs(harness.load_cell(CELL, ROOT).config, 3)
    pos = np.concatenate([m["positions"] for m in full.meshes])
    used = np.concatenate([m["positions"][m["faces"]].reshape(-1, 3)
                           for m in full.meshes])
    assert pos.max() == used.max() and pos.min() == used.min()


def test_the_sample_is_the_seeds():
    a = gen.sampled(500, 64 * 48, [3, 7], 11)
    assert sorted(a) == [3, 7]
    for k, px in a.items():
        assert len(np.unique(px)) == 500 and np.all(np.diff(px) > 0)
        assert px.min() >= 0 and px.max() < 64 * 48
        assert np.array_equal(px, gen.sampled(500, 64 * 48, [3, 7], 11)[k])
    assert not np.array_equal(a[3], a[7])  # frames draw their own
    assert not np.array_equal(a[3], gen.sampled(500, 64 * 48, [3, 7],
                                                2 ** 33 + 11)[3])
    assert np.array_equal(gen.sampled(5000, 64 * 48, [1], 11)[1],
                          np.arange(64 * 48))


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_control_fails_and_program_passes(seed):
    cell = small_cell(CELL)
    kind = KINDS["bounce_orbit"](cell.config, cell.traffic, seed, CPU)
    kind.release()
    control = kind.control()
    assert not checks.verdict(control, cell.limits), control
    out = run_small(cell, seed)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", FAULTS["bounce_orbit"])
def test_a_broken_bounce_run_is_not_correct(fault):
    cell = small_cell(CELL)
    with planted("bounce_orbit", fault):
        out = run_small(cell)
    assert not out["correct"], out["checks"]
    assert run_small(cell)["correct"]  # and the fault is gone again


def test_the_kind_refuses_another_ambient():
    cell = small_cell(CELL)
    config = dict(cell.config, ambient=0.1)
    with pytest.raises(ValueError, match="ambient"):
        KINDS["bounce_orbit"](config, cell.traffic, 3, CPU)


@pytest.mark.parametrize("name", ["bunny69k.c512", "armadillo346k-f16.c1024",
                                  "bunny69k.bvh512", "multimesh515k.c1080"])
def test_reflectivity_reaches_both_sides_and_nothing_else(name):
    """A configuration without ``reflectivity`` builds the program's scene
    and the reference's tables exactly as without the key (`Material`'s
    default, a zero a face); the bounce configuration's reach both."""
    from raytracercuda_torch.models.scene import Material, flatten_meshes

    config = copy.deepcopy(
        harness.load_cell({"bunny69k.c512": "bunny69k.c512.near",
                           "armadillo346k-f16.c1024":
                           "armadillo346k-f16.c1024.adam",
                           "bunny69k.bvh512": "bunny69k.bvh512.near",
                           "multimesh515k.c1080": CELL}[name], ROOT).config)
    for mesh in config["meshes"]:
        mesh["faces"] = 300
    inputs = scenes.make_inputs(config, 5)
    _, scene = scenes.port_scene(inputs, config, CPU)
    data = scene.data()
    ref = scenes.ref_scene(inputs, CPU)
    want = [m.get("reflectivity", 0.0) for m in config["materials"]]
    assert inputs.reflectivity == want
    assert torch.equal(data.reflectivity, torch.tensor(want))
    assert torch.equal(ref.face_reflectivity,
                       torch.tensor(want)[ref.face_material])
    if not any(want):
        old = flatten_meshes(scene.meshes,
                             [Material(albedo=a, texture_id=t)
                              for a, t in inputs.materials],
                             list(inputs.textures), CPU)
        for field in data._fields:
            a, b = getattr(data, field), getattr(old, field)
            if isinstance(a, dict):
                assert all(torch.equal(a[k], b[k]) for k in a), field
            else:
                assert torch.equal(a, b), field
        eye = torch.tensor([0.0, 0.3, -6.0])
        rays = render.camera_rays(24, 24)
        frame = render.render_frame(ref, eye, torch.eye(3), rays, 24, 24,
                                    scenes.shading(config))
        mirrors = ref._replace(
            face_reflectivity=torch.ones_like(ref.face_reflectivity))
        plain = render.render_frame(mirrors, eye, torch.eye(3), rays, 24, 24,
                                    scenes.shading(config))
        assert torch.equal(frame, plain)


# ---------------------------------------------------------------------------
# The readers.
# ---------------------------------------------------------------------------


class Event:
    """The raw profiler event's interface that `reduce_events` reads."""

    def __init__(self, name, device, start_us, dur_us):
        self._name, self._device = name, device
        self._start, self._dur = start_us * 1000, dur_us * 1000

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def _trace(calls=None, f=True):
    """Two frames: A (its fill overload, sweep, epilogue), B, then F twice,
    the second launch with no sweep (no tile listed a cluster); E's fill
    and a copy beside them.  The events come out of time order, as the
    profiler may give them."""
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ns = "void (anonymous namespace)::"
    fill = "fill_keys_kernel(unsigned long long*, long long)"
    events = [
        Event(tracing.WINDOW, cpu, 0, 2000),
        Event(ns + "sweep_items_kernel<false, true>(int const*)", gpu, 20, 70),
        Event(ns + fill, gpu, 0, 15),  # A's overload, same short name
        Event(ns + "shade_epilogue_kernel<false>(float*)", gpu, 100, 30),
        Event(ns + "occlusion_items_kernel<false>(int const*)", gpu, 140, 40),
        Event(ns + fill, gpu, 200, 9),  # E's
        Event("Memcpy DtoD (Device -> Device)", gpu, 215, 5),
    ]
    if f:
        events += [
            Event(ns + fill, gpu, 300, 11),
            Event(ns + "sweep_items_kernel<true, true>(int const*)", gpu, 320,
                  400),
            Event(ns + "shade_epilogue_kernel<true>(float*)", gpu, 730, 50),
            Event(ns + fill, gpu, 800, 7),
            Event(ns + "shade_epilogue_kernel<true>(float*)", gpu, 810, 20),
        ]
    return tracing.reduce_events(events, 2, {}, calls or {})


def _read(name, trace):
    return tracing.load_reader(name).read(trace)


def _call(tests, nbytes_):
    return tracing.Call(torch.tensor(tests, dtype=torch.int64), nbytes_)


def test_bounce_ms_takes_f_and_its_own_fills_alone():
    t = _trace()
    assert bounce_roofline.launches_us(t) == [11 + 400 + 50, 7 + 20]
    assert _read("bounce_ms.frame", t) == pytest.approx((461 + 27) / 2e3)


def test_general_roofline_is_the_bound_over_the_mean_launch():
    calls = {bounce_roofline.WRAPPER: [_call(10 ** 9, 10 ** 8),
                                       _call(10 ** 6, 10 ** 8),
                                       _call(10 ** 6, 10 ** 8)]}
    want_bound = (bound(10 ** 9 * MT_OPS, 1e8)
                  + 2 * bound(10 ** 6 * MT_OPS, 1e8))
    # Two launches recorded of three calls: the mean times the calls.
    want = 100 * want_bound / ((461 + 27) / 2 * 3 / 1e3)
    assert _read("general_roofline.frame", _trace(calls)) == \
        pytest.approx(want)


def test_the_f_readers_find_nothing_without_f():
    calls = {bounce_roofline.WRAPPER: [_call(10 ** 6, 10 ** 8)]}
    assert _read("bounce_ms.frame", _trace(calls, f=False)) is None
    assert _read("general_roofline.frame", _trace(calls, f=False)) is None
    assert _read("general_roofline.frame", _trace()) is None  # no call


class _Tracer:
    """The part of `tracing.Tracer` that `bounce_roofline.install` uses,
    its patches undone by ``monkeypatch``."""

    def __init__(self, monkeypatch):
        self.monkeypatch, self.calls = monkeypatch, []

    def patch(self, module, attr, fn):
        self.monkeypatch.setattr(module, attr, fn)

    def count(self, wrapper, tests, nbytes_):
        self.calls.append((wrapper, int(tests), nbytes_))


def test_install_counts_the_active_rays_tests_at_fs_wrapper(monkeypatch):
    """Each listed cluster's triangles for each active ray of its tile,
    and the bytes of the wrapper's inputs and outputs; its result passes
    through."""
    from raytracercuda_torch.trace import bounce_sweep
    from raytracercuda_torch.trace.sweep import TileLists

    tiles, rays, g = 3, 8, 4
    counts = torch.tensor([2, 0, 5], dtype=torch.int32)
    lists = TileLists(ids=torch.zeros(7, dtype=torch.int32), counts=counts,
                      offsets=torch.tensor([0, 2, 2, 7], dtype=torch.int32))
    active = torch.zeros(tiles, rays, dtype=torch.bool)
    active[0, :3] = True
    active[1, :] = True
    active[2, 5:] = True
    o3 = torch.zeros(tiles, 3, rays)
    blocks = torch.zeros(2, g, 16)
    out = (torch.zeros(tiles, rays),)
    monkeypatch.setattr(bounce_sweep, "_general_shade_cuda",
                        lambda *a: out)
    tracer = _Tracer(monkeypatch)
    bounce_roofline.install(tracer)
    args = (lists, o3, o3, active, blocks, True, 1e-4, blocks[:, :, :9])
    assert bounce_sweep._general_shade_cuda(*args) is out
    assert tracer.calls == [(bounce_roofline.WRAPPER,
                             (2 * 3 + 0 * 8 + 5 * 3) * g,
                             nbytes(*args, out))]
