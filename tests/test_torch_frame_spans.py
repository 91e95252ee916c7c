"""The program's spans and counters in the bounce frame
(`trace/bounce.py:render_bounces`, both routes) and the public API's
frame (`Camera.clear`, `Camera.trace_scene` -> `Scene.march`): their span
trees, the frames bit-equal with tracing on and off, the host copies
counted under ``host_syncs``, the general cull's ``general_pairs`` in a
bounce frame and in `bounce_sweep.trace_rays`, and the benchmark's
readers of them (`portbench/metrics/`) on synthetic slices.

CPU tests run on small scenes through the kernels' plain versions.  The
tests marked ``card`` need an NVIDIA GPU and skip without one; on the
card: ``python -m pytest tests/test_torch_frame_spans.py -m card
--noconftest`` (where jax is absent, this file imports none)."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench import program, tracing
from raytracercuda_torch.config import AccelKind, RenderConfig
from raytracercuda_torch.models.camera import (Camera, camera_ray_grid,
                                               orient_from_pan_pitch)
from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
from raytracercuda_torch.models.render_target import RenderTarget
from raytracercuda_torch.models.scene import Material, Scene
from raytracercuda_torch.trace import bounce_sweep
from raytracercuda_torch.trace.bounce import render_bounces
from raytracercuda_torch.trace.pipeline import rotate_rays
from raytracercuda_torch.trace.sweep import segment_blocks
from raytracercuda_torch.utils import profiler
from raytracercuda_torch.utils.profiler import Record, Span, collect
from raytracercuda_torch.utils.profiler import tracing as traced
from test_torch_bounce import bounce2  # noqa: F401  (a fixture)
from test_torch_tracing import _card, _sync_sites, check_record, tree
from torch_parity import time_limit as _time_limit

CONFIG = RenderConfig(accel=AccelKind.CLUSTER)
BRUTE = RenderConfig(accel=AccelKind.BRUTE)
LIGHT = (0.4, 0.8, -0.45)
BACKGROUND = (0.0, 1.0, 0.0)
MISS = 255 << 8


@pytest.fixture(autouse=True)
def time_limit():
    """Each test within 120 s, from and to an empty record."""
    with _time_limit(120.0):
        collect()
        yield
        assert not profiler.enabled
        collect()


class Mirrors:
    """Two bumpy spheres in front of the eye, both in part mirrors, their
    clusters and the pinhole rays of a ``width`` x ``height`` frame: a
    bounce frame's inputs, on ``device``."""

    def __init__(self, faces=(600, 400), width=32, height=32, device="cpu"):
        scene = Scene(CONFIG, device=device)
        for i, (n, centre) in enumerate(zip(faces, ((-0.6, 0.0, 3.0),
                                                    (0.7, 0.2, 3.4)))):
            mesh = bumpy_sphere_mesh(n, 0.6, centre, seed=3 + i)
            mesh.material_id = i
            scene.add_mesh(mesh)
        scene.materials = [Material(albedo=(0.8, 0.7, 0.6), texture_id=0,
                                    reflectivity=0.4),
                           Material(albedo=(0.9, 0.9, 0.9),
                                    reflectivity=0.7)]
        scene.textures = [np.random.default_rng(1).random(
            (8, 8, 3), dtype=np.float32)]
        self.data, self.accel = scene.data(), scene.accel
        self.width, self.height = width, height
        self.eye = torch.tensor([0.05, 0.1, 0.0], device=device)
        orient = torch.as_tensor(orient_from_pan_pitch(0.1, -0.05),
                                 dtype=torch.float32, device=device)
        self.dirs = rotate_rays(camera_ray_grid(width, height, device=device),
                                orient)

    def frame(self, use_brute=False, num_bounces=2):
        return render_bounces(self.accel, self.data, self.eye, self.dirs,
                              self.height, self.width, CONFIG,
                              num_bounces=num_bounces, light_dir=LIGHT,
                              with_shadows=True, background=BACKGROUND,
                              use_brute=use_brute)


class Api:
    """A library user's frame through the public API on BRUTE: a bumpy
    sphere, a camera with the reference's lens, a locked target; the pose
    passed as host float32 arrays."""

    def __init__(self, faces=500, side=32, device="cpu"):
        self.scene = Scene(BRUTE, device=device)
        self.scene.add_mesh(bumpy_sphere_mesh(faces, 1.0, (0.0, 0.0, 0.0),
                                              seed=2))
        self.cam = Camera.create(device)
        assert self.cam.set_initial_rays(side, side, -1, 1, -1, 1, 1) == 0
        self.target = RenderTarget.create(side, side, device)
        assert self.target.lock() == 0
        self.eye = np.array([0.1, 0.0, -2.1], np.float32)
        self.orient = np.asarray(orient_from_pan_pitch(0.2, 0.1), np.float32)

    def frame(self, eye=None, orient=None):
        assert self.cam.clear(self.target, MISS) == 0
        assert self.cam.trace_scene(
            self.eye if eye is None else eye,
            self.orient if orient is None else orient, self.scene,
            self.target) == 0
        return self.target.buffer


@pytest.fixture(scope="module")
def mirrors():
    return Mirrors()


@pytest.fixture(scope="module")
def api():
    return Api()


def bounce_tree(num_bounces: int) -> list:
    """The spans of a cluster-route bounce frame."""
    per_bounce = [(1, "bounce.rays"), (1, "sweep.general_cull"),
                  (2, "sync.tile_lists"), (1, "sweep.F"),
                  (1, "bounce.shade")]
    return [(0, "frame"), (1, "bounce.blocks"), (1, "sync.constants"),
            (1, "sweep.cull"), (2, "sync.tile_lists"), (1, "sweep.A"),
            (1, "frame.shadow_rays"), (1, "sweep.shadow_cull"),
            (2, "sync.tile_lists"), (1, "sweep.B"), (1, "frame.shade"),
            *per_bounce * num_bounces]


API_TREE = [(0, "api.clear"), (0, "frame"), (1, "sync.pose"),
            (1, "frame.rays"), (1, "frame.trace"), (1, "frame.shade")]


def _listed(monkeypatch, name: str) -> list:
    """The lists' pair count at each call of `bounce_sweep`'s plain sweep
    ``name``."""
    listed = []
    real = getattr(bounce_sweep, name)

    def counted(lists, *args):
        listed.append(lists.ids.numel())
        return real(lists, *args)

    monkeypatch.setattr(bounce_sweep, name, counted)
    return listed


@pytest.mark.parametrize("num_bounces", [0, 2])
def test_a_bounce_frame_records_its_phases_under_one_root(
        mirrors, monkeypatch, num_bounces):
    listed = _listed(monkeypatch, "_general_shade_plain")
    with traced():
        mirrors.frame(num_bounces=num_bounces)
    record = collect()
    check_record(record)
    assert tree(record) == bounce_tree(num_bounces)
    assert len({s.unit for s in record.spans}) == 1
    # The two constants and each cull's lists.
    want = {"host_syncs": 2 + 2 + num_bounces}
    if num_bounces:
        assert len(listed) == num_bounces and min(listed) > 0
        want["general_pairs"] = sum(listed)
    assert record.counters == want


def test_the_brute_bounce_route_counts_its_host_copies(mirrors):
    """The brute route's root holds the copies of ``t_epsilon`` and the
    light, and each `shade_lambert_rgb` call's copies of the light and
    the background, one depth each."""
    with traced():
        mirrors.frame(use_brute=True)
    record = collect()
    check_record(record)
    assert tree(record) == [(0, "frame"), (1, "sync.constants"),
                            *[(1, "sync.shade_constants")] * 3]
    assert record.counters == {"host_syncs": 2 + 3 * 2}


def test_an_api_frame_records_its_phases(api):
    with traced():
        api.frame()
    record = collect()
    check_record(record)
    assert tree(record) == API_TREE
    assert [s.name for s in record.spans if s.parent is None] == [
        "api.clear", "frame"]
    assert record.counters == {"host_syncs": 2}


def test_a_pose_already_on_the_device_is_not_counted(api):
    with traced():
        api.frame(torch.as_tensor(api.eye), torch.as_tensor(api.orient))
    record = collect()
    assert tree(record) == [x for x in API_TREE if x[1] != "sync.pose"]
    assert record.counters == {}


def test_host_copies_counts_host_values_only():
    cpu = torch.device("cpu")
    values = ((0.5, 1.0), 2.0, np.ones(3), torch.ones(3))
    with traced():
        with profiler.host_copies("sync.a", values, cpu):
            pass
        with profiler.host_copies("sync.b", (torch.ones(2),), cpu):
            pass
        # A CPU tensor bound for a card is a copy from the host.
        with profiler.host_copies("sync.c", (torch.ones(2),), "cuda"):
            pass
    record = collect()
    assert [s.name for s in record.spans] == ["sync.a", "sync.c"]
    assert record.counters == {"host_syncs": 4}
    assert profiler.host_copies("sync.d", values, cpu) is profiler.span("x")


@pytest.mark.parametrize("route", ["bounce", "bounce_brute", "api"])
def test_frames_are_bit_equal_with_tracing_on(mirrors, api, route):
    run = {"bounce": mirrors.frame,
           "bounce_brute": lambda: mirrors.frame(use_brute=True),
           "api": lambda: api.frame().clone()}[route]
    off = run()
    with traced():
        on = run()
    assert len(collect().spans) > 0
    assert off.dtype == on.dtype and off.shape == on.shape
    bits = torch.int32
    assert torch.equal(off.view(bits), on.view(bits))


def test_trace_rays_counts_the_pairs_its_groups_listed(mirrors, monkeypatch):
    listed = _listed(monkeypatch, "_closest_rays_plain")
    rng = np.random.default_rng(7)
    origins = torch.from_numpy(rng.uniform(-0.5, 0.5, (700, 3))
                               .astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(0.0, 0.3, (700, 3)).astype(np.float32)
        + np.float32([0.0, 0.0, 1.0])), dim=1)
    with traced():
        bounce_sweep.trace_rays(mirrors.accel, segment_blocks(mirrors.accel),
                                origins, dirs)
    record = collect()
    check_record(record)
    assert tree(record) == [(0, "sweep.general_cull"), (1, "sync.tile_lists"),
                            (0, "sweep.probes")]
    assert len(listed) == 1 and listed[0] > 0
    assert record.counters == {"general_pairs": listed[0], "host_syncs": 1}


# ---------------------------------------------------------------------------
# The readers, on synthetic slices.
# ---------------------------------------------------------------------------

US = 1000  # ns a microsecond


def _slice(monkeypatch, record, units=2, activities=()):
    """A `TraceData` of ``units`` units and the device ``activities``
    (name, start us, duration us), whose program record is ``record``."""
    trace = tracing.TraceData(units, 1.0, 0.5, list(activities), [], {}, {})
    fake = types.SimpleNamespace(enabled=False, collect=lambda: record)
    monkeypatch.setattr(program, "_facility", lambda: fake)
    monkeypatch.setattr(program, "_last", None)
    return trace


def _read(name, trace):
    return tracing.load_reader(name).read(trace)


#: Device busy 100-300, 250-400 (overlapping), 900-1100, 2100-2200 us.
ACTIVITIES = [("a", 100.0, 200.0), ("b", 250.0, 150.0), ("c", 900.0, 200.0),
              ("d", 2100.0, 100.0)]


def _roots(first: str, counters: dict) -> Record:
    """Two units: roots ``first`` at 0-1000 us and ``frame`` at 2000-2600
    us, with a child span each."""
    return Record([
        Span(2, "sync.tile_lists", 150 * US, 350 * US, 1, 1),
        Span(1, first, 0, 1000 * US, None, 1),
        Span(4, "sync.pose", 2050 * US, 2100 * US, 3, 3),
        Span(3, "frame", 2000 * US, 2600 * US, None, 3),
    ], counters)


#: Idle inside the roots a unit: 1000 us less 100-400 and 900-1000 busy,
#: 600 less 100.
IDLE_MS = ((1000 - 300 - 100) + (600 - 100)) / 1e3 / 2


@pytest.mark.parametrize("first", ["frame", "api.clear"])
def test_the_frame_readers_on_a_synthetic_slice(monkeypatch, first):
    record = _roots(first, {"host_syncs": 6, "general_pairs": 4000})
    trace = _slice(monkeypatch, record, 2, ACTIVITIES)
    assert _read("bounce_glue_idle_ms.frame", trace) == pytest.approx(IDLE_MS)
    assert _read("api_glue_idle_ms.frame", trace) == pytest.approx(IDLE_MS)
    assert _read("api_host_syncs.frame", trace) == pytest.approx(3.0)
    assert _read("general_pairs.frame", trace) == pytest.approx(2000.0)
    assert _read("general_pairs.step", trace) == pytest.approx(2000.0)


READERS = ["bounce_glue_idle_ms.frame", "api_glue_idle_ms.frame",
           "api_host_syncs.frame", "general_pairs.frame",
           "general_pairs.step"]


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_without_its_spans_or_counter(monkeypatch, name):
    """No record (a program without the facility, or no span recorded),
    and a record of the spans a program without a ``frame`` root in the
    bounce frame recorded: standalone sweeps, and no ``general_pairs``."""
    assert _read(name, _slice(monkeypatch, None)) is None
    assert _read(name, _slice(monkeypatch, Record([], {"host_syncs": 2}))) \
        is None
    rootless = Record([Span(1, "sweep.cull", 0, 100 * US, None, 1),
                       Span(2, "sync.tile_lists", 10 * US, 90 * US, 1, 1)],
                      {"host_syncs": 4, "rays_listed": 10})
    assert _read(name, _slice(monkeypatch, rootless, 2, ACTIVITIES)) is None


def test_the_new_readers_are_declared_in_their_cells():
    import json
    from pathlib import Path

    spec = json.loads((Path(tracing.__file__).resolve().parents[1]
                       / "BENCHMARK.json").read_text())
    cells = {m["name"]: m["workloads"] for m in spec["per_layer"]}
    assert cells["bounce_glue_idle_ms.frame"] == cells[
        "general_pairs.frame"] == ["multimesh515k.c1080.bounce2"]
    assert cells["api_glue_idle_ms.frame"] == cells[
        "api_host_syncs.frame"] == ["suzanne15k.brute256.api"]
    assert cells["general_pairs.step"] == [
        "armadillo346k-f16.c1024.silhouette"]


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _bounce2_frame(bounce2, width=None, height=None, use_brute=False):
    """A function that renders pose 0 of bounce2's orbit through
    `render_bounces`, at the cell's size unless ``width`` and ``height``
    say otherwise; the pose and rays are on the card before it runs."""
    config, data, accel, poses = bounce2
    dev = data.positions.device
    eye, orient = (torch.as_tensor(x, device=dev) for x in poses[0])
    w, h = width or config["width"], height or config["height"]
    dirs = rotate_rays(camera_ray_grid(w, h, device=dev), orient)
    torch.cuda.synchronize()

    def frame():
        return render_bounces(
            accel, data, eye, dirs, h, w, CONFIG, num_bounces=2,
            light_dir=tuple(config["light_dir"]),
            with_shadows=config["shadows"],
            background=tuple(config["background"]), use_brute=use_brute)

    return frame


def _counted_sites(run) -> tuple:
    """``run`` once untraced, then traced under the sync debug mode:
    (the innermost span at each synchronizing call torch reports, the
    record)."""
    run()
    torch.cuda.synchronize()
    collect()
    sites = _sync_sites(run)
    return sites, collect()


@pytest.mark.card
@pytest.mark.parametrize("route", ["cluster", "brute"])
def test_a_bounce2_frame_counts_every_synchronizing_call(bounce2, route):
    """The cluster route at 1920x1080 and the brute route at 256x144 over
    bounce2's 515,397 faces: every call torch reports waits inside a
    ``sync.*`` span, and ``host_syncs`` counts each."""
    if route == "cluster":
        sites, record = _counted_sites(_bounce2_frame(bounce2))
        assert sites == ["sync.constants"] * 2 + ["sync.tile_lists"] * 4
    else:
        sites, record = _counted_sites(_bounce2_frame(
            bounce2, 256, 144, use_brute=True))
        assert sites == ["sync.constants"] * 2 \
            + ["sync.shade_constants"] * 6
    check_record(record)
    assert record.counters["host_syncs"] == len(sites)
    assert [s.name for s in record.spans if s.parent is None] == ["frame"]


@pytest.mark.card
def test_an_api_frame_counts_every_synchronizing_call():
    """The api cell's shape: 15,488 faces on BRUTE at 256x256."""
    a = Api(15488, 256, _card())
    sites, record = _counted_sites(a.frame)
    assert sites == ["sync.pose", "sync.pose"]
    assert tree(record) == API_TREE
    assert record.counters == {"host_syncs": 2}


def _launched_inside(prof, record, span_name, kernels) -> int:
    """Each device activity whose name holds one of ``kernels``: its
    launch (the runtime call of its correlation id) lies inside a span
    ``span_name`` and the kernel starts after that span starts, on the
    profiler's clock.  Returns the number of such activities."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    launches = {e.correlation_id(): e for e in events
                if e.device_type() == DeviceType.CPU
                and e.name().startswith("cuda")}
    spans = [s for s in record.spans if s.name == span_name]
    assert spans
    found = 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or not any(
                k in e.name() for k in kernels):
            continue
        launch = launches[e.correlation_id()]
        lo, hi = launch.start_ns(), launch.start_ns() + launch.duration_ns()
        assert any(s.start_ns <= lo and hi <= s.end_ns
                   and s.start_ns <= e.start_ns() for s in spans), e.name()
        found += 1
    return found


@pytest.mark.card
def test_kernels_f_e_and_d_run_inside_their_spans(bounce2):
    from torch.profiler import ProfilerActivity, profile

    a = Api(15488, 256, _card())
    bounce = _bounce2_frame(bounce2)
    for run in (bounce, a.frame):
        run()
    torch.cuda.synchronize()
    collect()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with traced():
            bounce()
            a.frame()
        torch.cuda.synchronize()
    record = collect()
    # Two launches of F, each its sweep and its epilogue.
    assert _launched_inside(prof, record, "sweep.F", (
        "sweep_items_kernel<true, true>", "shade_epilogue_kernel<true>")) \
        == 4
    assert _launched_inside(prof, record, "frame.trace", (
        "brute_items_kernel", "brute_epilogue_kernel")) == 2
    assert _launched_inside(prof, record, "api.clear", ("clear_kernel",)) \
        == 1
