"""The port's program tracing (`raytracercuda_torch/utils/profiler.py`):
spans and counters off and on, the span trees of a CLUSTER frame, a
progressive pass and a gradient step, results unchanged by tracing, the
clock shared with `torch.profiler`, and `device_trace`'s export.

CPU tests run on small scenes through the kernels' plain versions.  The
tests marked ``card`` need an NVIDIA GPU and skip without one; on the
card: ``python -m pytest tests/test_torch_tracing.py -m card
--noconftest`` (this file imports no jax)."""

from __future__ import annotations

import json
import signal
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from raytracercuda_torch.accel.clusters import build_clusters
from raytracercuda_torch.config import AccelKind, RenderConfig
from raytracercuda_torch.diff import render_grad
from raytracercuda_torch.models.camera import (camera_ray_grid,
                                               orient_from_pan_pitch)
from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
from raytracercuda_torch.models.scene import Material, Scene
from raytracercuda_torch.trace import sweep
from raytracercuda_torch.trace.frame import FrameRenderer
from raytracercuda_torch.trace.progressive import (init_progressive,
                                                   progressive_step)
from raytracercuda_torch.utils import profiler
from raytracercuda_torch.utils.profiler import (Profiler, collect,
                                                device_trace, span,
                                                tracing)

torch.set_num_threads(1)
CONFIG = RenderConfig(accel=AccelKind.CLUSTER)
SIDE = 32


@pytest.fixture(autouse=True)
def time_limit():
    """Each test within 120 s (SIGALRM), from and to an empty record."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its limit of 120 s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, 120.0)
    collect()
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        assert not profiler.enabled
        collect()


class Small:
    """A textured bumpy sphere in front of the eye, its clusters and the
    pinhole rays of a ``side``-pixel frame, on ``device``."""

    def __init__(self, faces=800, side=SIDE, device="cpu"):
        scene = Scene(CONFIG, device=device)
        mesh = bumpy_sphere_mesh(faces, 1.0, (0.0, 0.0, 3.0), seed=3)
        mesh.material_id = 0
        scene.add_mesh(mesh)
        scene.materials = [Material(albedo=(0.8, 0.7, 0.6), texture_id=0)]
        scene.textures = [np.random.default_rng(1).random(
            (8, 8, 3), dtype=np.float32)]
        self.data, self.accel, self.side = scene.data(), scene.accel, side
        self.rays = camera_ray_grid(side, side, device=device)
        self.eye = torch.tensor([0.1, 0.0, 0.0], device=device)
        self.orient = torch.as_tensor(orient_from_pan_pitch(0.0, 0.0),
                                      dtype=torch.float32, device=device)
        self.target = torch.rand(side * side, 3,
                                 generator=torch.Generator().manual_seed(2)
                                 ).to(device)
        self.renderer = FrameRenderer(self.data, self.accel, CONFIG, side,
                                      side)

    def frame(self):
        return self.renderer.render(self.eye, self.orient, self.rays)

    def progressive(self):
        state = init_progressive(self.side * self.side,
                                 device=self.data.device)
        with torch.no_grad():
            return progressive_step(state, self.data, self.accel, self.eye,
                                    self.orient, self.side, self.side,
                                    CONFIG, with_shadows=True).image

    def step(self, vjp=False):
        """One step of the adam cell's shape: rebuild, a shadowed render
        and its loss, ``backward()``; -> (loss, position and texture
        gradients).  ``vjp``: through `render_rgb_vjp` instead."""
        p = self.data.positions.clone().requires_grad_()
        tex = self.data.textures.clone().requires_grad_()
        accel = build_clusters(p.detach(), self.data.faces, CONFIG.cluster)
        scene = self.data._replace(positions=p, textures=tex)
        kw = dict(frame_hw=(self.side, self.side), with_shadows=True)
        if vjp:
            img = render_grad.render_rgb_vjp(scene, accel, self.rays,
                                             self.eye, self.orient, CONFIG,
                                             **kw)
            loss = torch.mean((img - self.target) ** 2)
        else:
            loss = render_grad.l2_image_loss(scene, accel, self.rays,
                                             self.eye, self.orient,
                                             self.target, CONFIG, **kw)
        loss.backward()
        return loss.detach(), p.grad, tex.grad


@pytest.fixture(scope="module")
def small():
    return Small()


def tree(record) -> list:
    """``(depth, name)`` of each span in start order, by its parents."""
    by_id = {s.id: s for s in record.spans}

    def depth(s):
        d = 0
        while s.parent is not None:
            s, d = by_id[s.parent], d + 1
        return d

    return [(depth(s), s.name)
            for s in sorted(record.spans, key=lambda s: (s.start_ns, s.id))]


def check_record(record) -> None:
    """Every span has its own id, ends after it starts, lies inside its
    parent and carries its root's id."""
    by_id = {s.id: s for s in record.spans}
    assert len(by_id) == len(record.spans)
    for s in record.spans:
        assert s.end_ns >= s.start_ns
        if s.parent is None:
            assert s.unit == s.id
        else:
            p = by_id[s.parent]
            assert s.unit == p.unit
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


SHADOW_LISTS = [(2, "sync.light_basis"), (2, "sync.tile_lists")]
FRAME_TREE = [(0, "frame"), (1, "frame.rays"), (1, "sweep.cull"),
              (2, "sync.tile_lists"), (1, "sweep.A"),
              (1, "frame.shadow_rays"), (1, "sweep.shadow_cull"),
              *SHADOW_LISTS, (1, "sweep.B"), (1, "frame.shade")]


def render_tree(depth: int) -> list:
    d = depth
    return [(d, "render"), (d + 1, "render.discrete"), (d + 2, "sweep.cull"),
            (d + 3, "sync.tile_lists"), (d + 2, "sweep.C"),
            (d + 2, "sync.occlusion_light"), (d + 2, "sweep.shadow_cull"),
            (d + 3, "sync.light_basis"), (d + 3, "sync.tile_lists"),
            (d + 2, "sweep.H"), (d + 1, "render.shade"),
            (d + 2, "sync.shade_light")]


def test_off_span_is_one_shared_object_and_records_nothing(small):
    assert not profiler.enabled
    assert span("a") is span("b") is profiler.host_sync("sync.c")
    with span("a") as s:
        assert s.open() is s
        s.close()
    profiler.count("host_syncs", 3)
    small.frame()
    record = collect()
    assert record.spans == [] and record.counters == {}


def test_tracing_restores_the_switch():
    with tracing():
        assert profiler.enabled
        with tracing():
            pass
        assert profiler.enabled
    assert not profiler.enabled


def _count_tile_lists(monkeypatch) -> list:
    calls = []
    real = sweep._tile_lists

    def counted(survive):
        calls.append(1)
        return real(survive)

    monkeypatch.setattr(sweep, "_tile_lists", counted)
    return calls


def test_frame_records_its_phases(small, monkeypatch):
    calls = _count_tile_lists(monkeypatch)
    with tracing():
        small.frame()
    record = collect()
    check_record(record)
    assert tree(record) == FRAME_TREE
    assert len({s.unit for s in record.spans}) == 1
    assert len(calls) == 2
    assert record.counters == {"host_syncs": len(calls) + 2}


def test_progressive_pass_records_its_phases(small, monkeypatch):
    calls = _count_tile_lists(monkeypatch)
    with tracing():
        small.progressive()
    record = collect()
    check_record(record)
    assert tree(record) == [(0, "pass"), (1, "sync.jitter"),
                            *render_tree(1)]
    assert len(calls) == 2
    # The lists, the jitter's two copies, the light basis's two, the
    # occlusion's and the shade's light.
    assert record.counters == {"host_syncs": len(calls) + 6}


def test_grad_step_records_build_render_and_grad(small, monkeypatch):
    calls = _count_tile_lists(monkeypatch)
    with tracing():
        small.step()
    record = collect()
    check_record(record)
    want = [(0, "accel.build"), *render_tree(0), (0, "grad"),
            (1, "scatter.G"), (1, "scatter.G")]
    assert tree(record) == want
    roots = [s for s in record.spans if s.parent is None]
    assert [s.name for s in roots] == ["accel.build", "render", "grad"]
    assert len({s.unit for s in record.spans}) == 3
    assert len(calls) == 2
    assert record.counters == {"host_syncs": len(calls) + 4}
    assert getattr(profiler._local, "stack", []) == []


def test_vjp_backward_records_recompute_and_autograd(small):
    with tracing():
        small.step(vjp=True)
    record = collect()
    check_record(record)
    names = tree(record)
    grad = names.index((0, "grad"))
    assert names[grad:] == [(0, "grad"), (1, "grad.recompute"),
                            (2, "sync.shade_light"), (1, "grad.autograd"),
                            (2, "scatter.G"), (2, "scatter.G")]


@pytest.mark.parametrize("route", ["frame", "progressive", "step", "vjp"])
def test_results_are_bit_equal_with_tracing_on(small, route):
    run = {"frame": lambda: (small.frame(),),
           "progressive": lambda: (small.progressive(),),
           "step": small.step,
           "vjp": lambda: small.step(vjp=True)}[route]
    off = run()
    with tracing():
        on = run()
    assert len(collect().spans) > 0
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_spans_nest_per_thread():
    seen = {}

    def other():
        with span("other") as s:
            seen["other"] = s

    with tracing():
        with span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    by_name = {s.name: s for s in collect().spans}
    assert by_name["other"].parent is None
    assert by_name["other"].unit == by_name["other"].id
    assert by_name["main"].parent is None


def test_a_span_closed_on_another_call_pops_its_own_entry():
    with tracing():
        outer = span("outer").open()
        with span("inner"):
            pass
        outer.close()
        assert getattr(profiler._local, "stack") == []
    assert [s.name for s in collect().spans] == ["inner", "outer"]


def test_an_aten_op_inside_a_span_lies_within_it_on_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing(), span("outer"):
            time.sleep(0.002)
            x.sum()
            time.sleep(0.002)
    (outer,) = collect().spans
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::sum"]
    assert ops
    for e in ops:
        assert outer.start_ns + 1_000_000 <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= outer.end_ns - 1_000_000


def test_device_trace_exports_the_program_spans(small, tmp_path):
    with device_trace(str(tmp_path / "trace")):
        small.frame()
    assert not profiler.enabled and collect().spans == []
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    program = [e for e in trace["traceEvents"]
               if e.get("cat") == "program" and e["ph"] == "X"]
    assert [e["name"] for e in sorted(program, key=lambda e: e["ts"])] \
        == [n for _, n in FRAME_TREE]
    # The profiler's operators lie on the spans' time base: every one of
    # the block inside the frame, a ``nonzero`` inside each list sync.
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops

    def inside(e, s):
        return s["ts"] <= e["ts"] + e["dur"] / 2 <= s["ts"] + s["dur"]

    (frame,) = [e for e in program if e["name"] == "frame"]
    assert all(inside(e, frame) for e in ops)
    syncs = [e for e in program if e["name"] == "sync.tile_lists"]
    assert len(syncs) == 2
    for s in syncs:
        assert any(inside(e, s) for e in ops if e["name"] == "aten::nonzero")
    counters = [e for e in trace["traceEvents"]
                if e.get("cat") == "program" and e["ph"] == "C"]
    assert counters[0]["args"] == {"host_syncs": 4}


def test_profiler_phase_is_a_span():
    prof = Profiler(interval=3600.0)
    with tracing():
        with prof.phase("Scene"):
            with span("inside"):
                pass
        with prof.phase("Trace", sync=[torch.zeros(2)]):
            pass
    assert tree(collect()) == [(0, "Scene"), (1, "inside"), (0, "Trace")]
    assert [i.name for i in prof.items] == ["Scene", "Trace"]


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    from raytracercuda_torch.ops import cuda_build

    cuda_build.load_library()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bench_sized():
    """A 69,451-face textured scene at 512x512, as the bench frame's."""
    return Small(69451, 512, _card())


@pytest.mark.card
def test_host_syncs_count_every_synchronizing_call(bench_sized):
    bench_sized.frame()
    bench_sized.step()
    torch.cuda.synchronize()
    collect()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with tracing():
                bench_sized.frame()
                bench_sized.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    record = collect()
    assert record.counters["host_syncs"] == len(syncs) == 10


@pytest.mark.card
def test_kernel_a_runs_inside_its_span_and_before_the_shadow_lists(
        bench_sized):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bench_sized.frame()
    torch.cuda.synchronize()
    collect()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tracing():
            bench_sized.frame()
        torch.cuda.synchronize()
    record = collect()
    by_id = {s.id: s for s in record.spans}
    (sweep_a,) = [s for s in record.spans if s.name == "sweep.A"]
    (shadow_lists,) = [s for s in record.spans
                       if s.name == "sync.tile_lists"
                       and by_id[s.parent].name == "sweep.shadow_cull"]
    a = [e for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CUDA
         and "sweep_items_kernel<false, true>" in e.name()]
    assert len(a) == 1
    start, end = a[0].start_ns(), a[0].start_ns() + a[0].duration_ns()
    assert sweep_a.start_ns <= start
    assert end <= shadow_lists.end_ns
