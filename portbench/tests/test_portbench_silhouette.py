"""The silhouette cell (`loops/silhouette.py`, `reference/silhouette.py`,
`probe_roofline.py` and its readers) on the CPU at a small size: the
kind's set-up and a unit, the seeds that pass, the faults and the
bfloat16 control that fail, and the readers on synthetic profiles."""

from __future__ import annotations

import contextlib
import copy
import json
import time

import pytest
import torch

from conftest import CPU, ROOT, run_small
from portbench import checks, harness, probe_roofline, program, tracing
from portbench.faults import faults_of, planted
from portbench.kinds import KINDS, kind_class
from portbench.yardstick import MT_OPS, bound, nbytes
from test_portbench_bounce import Event

CELL = "armadillo346k-f16.c1024.silhouette"


def small_cell(job_steps=4, trace_units=2):
    """The cell with the armadillo and the F16 at 3,000 and 300 faces, a
    48x48 frame and 4-step jobs; every other number as in its files."""
    cell = harness.load_cell(CELL, ROOT)
    config = copy.deepcopy(cell.config)
    for mesh, n in zip(config["meshes"], (300, 3000)):
        mesh["faces"] = n
    config["width"] = config["height"] = 48
    traffic = dict(cell.traffic, job_steps=job_steps,
                   trace_units=trace_units)
    return cell._replace(config=config, traffic=traffic)


def test_the_kind_lives_in_its_own_file():
    assert "silhouette" not in KINDS
    assert kind_class("silhouette").__module__.startswith("portbench_kind_")
    assert faults_of("silhouette") == ("no_boundary", "flipped")


def test_the_deployment_runs_config_4s_scene_unshadowed():
    """The cell's configuration is its own file and entry, and holds
    `armadillo346k-f16.c1024`'s scene number for number; only what names
    the deployment differs, and the shadows it does not render."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in spec["configs"]}
    cell = {w["name"]: w for w in spec["workloads"]}[CELL]
    mine, base = configs[cell["config"]], configs["armadillo346k-f16.c1024"]
    assert mine["file"] != base["file"] and mine["source"] != base["source"]
    assert mine["reduced"] == []
    got = json.loads((ROOT / mine["file"]).read_text())
    want = json.loads((ROOT / base["file"]).read_text())
    assert got["name"] == mine["name"] and got["source"] == mine["source"]
    assert got["shadows"] is False and want["shadows"] is True
    named = {"name", "source", "shadows", "deployment", "assumed"}
    assert set(got) - named == set(want) - named
    assert all(got[k] == want[k] for k in set(want) - named)


def test_a_configuration_with_shadows_is_refused():
    cell = small_cell()
    with pytest.raises(ValueError, match="shadow"):
        kind_class("silhouette")(dict(cell.config, shadows=True),
                                 cell.traffic, 3, CPU)


def test_set_up_holds_the_table_on_the_device_and_makes_the_targets():
    cell = small_cell()
    kind = kind_class("silhouette")(cell.config, cell.traffic, 3, CPU)
    assert len(kind.targets) == kind.views == 8
    assert all(t.shape == (48 * 48, 3) for t in kind.targets)
    vids, faces = kind.edges
    assert vids.dtype == faces.dtype == torch.int32
    assert vids.device == faces.device == CPU
    # The views circle the armadillo at 1.8 of its radii.
    centre = torch.tensor(cell.config["meshes"][1]["center"])
    dist = (kind.eyes - centre).norm(dim=1)
    assert torch.allclose(dist, torch.full((8,), 7.2), atol=1e-5)
    # The targets differ from the start shape's renders: the outline moved.
    kind.warm_up()
    assert len(kind.losses) == 3 and all(l > 0 for l in kind.losses)
    assert (kind.change != 0).any() and (kind.grad != 0).any()
    kind.unit(0, tracing.Tracer(CPU))
    assert kind.job == 4


class _Spans:
    """A tracer that records the names of the spans a unit opens."""

    def __init__(self):
        self.names = []

    @contextlib.contextmanager
    def span(self, name):
        self.names.append(name)
        yield


def test_a_step_opens_the_rebuild_and_backward_spans():
    """`rebuild_ms.step` and `backward_ms.step` read these, as in the
    adam cell."""
    cell = small_cell()
    kind = kind_class("silhouette")(cell.config, cell.traffic, 3, CPU)
    spans = _Spans()
    kind.unit(0, spans)
    kind.unit(1, spans)
    assert spans.names == ["rebuild", "backward"] * 2


def test_a_program_with_camera_space_probes_is_refused_at_once(
        monkeypatch):
    from raytracercuda_torch.diff import edge_grad

    monkeypatch.delattr(edge_grad, "_probe_world")
    cell = small_cell()
    with pytest.raises(RuntimeError, match="_probe_world"):
        kind_class("silhouette")(cell.config, cell.traffic, 3, CPU)


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_seeds_pass(seed):
    out = run_small(small_cell(), seed)
    assert out["correct"], out["checks"]
    assert out["checks"]["grad_gap"]["value"] < 1e-4


@pytest.mark.parametrize("fault", ["no_boundary", "flipped"])
def test_a_broken_term_is_not_correct(fault):
    cell = small_cell()
    with planted("silhouette", fault):
        out = run_small(cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["grad_gap"]["value"] > 0.3
    assert run_small(cell)["correct"]  # and the fault is gone again


def test_the_control_fails():
    cell = small_cell()
    kind = kind_class("silhouette")(cell.config, cell.traffic, 3, CPU)
    kind.release()
    control = kind.control()
    assert not checks.verdict(control, cell.limits), control


# ---------------------------------------------------------------------------
# The readers.
# ---------------------------------------------------------------------------

NS = "void (anonymous namespace)::"
FILL = NS + "fill_keys_kernel(unsigned long long*, long long)"
SWEEP = NS + "sweep_items_kernel<true, true>(int const*)"
EPILOGUE = NS + "closest_epilogue_kernel<true, true>(float*)"
CULL = NS + "general_cull_kernel(float const*)"


def _trace(calls=None, probes=True, drop_fill=False):
    """Two steps: C's fill, sweep and epilogue and G's scatter beside the
    probes' general cull and sweep; the second probe call with no sweep
    (no tile listed a cluster).  ``drop_fill`` loses the first probe
    call's fill, as the profiler may drop a launch.  Out of time order."""
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        Event(tracing.WINDOW, cpu, 0, 3000),
        Event(NS + "sweep_items_kernel<false, false>(int const*)", gpu, 20,
              300),
        Event(FILL, gpu, 0, 15),  # C's fill
        Event(NS + "closest_epilogue_kernel<false, false>(float*)", gpu, 330,
              30),
        Event(NS + "scatter_add_kernel<22>(float*)", gpu, 400, 40),
    ]
    if probes:
        events += [
            Event(CULL, gpu, 500, 12),
            Event(SWEEP, gpu, 540, 200),
            Event(EPILOGUE, gpu, 750, 25),
            Event(CULL, gpu, 900, 8),
            Event(FILL, gpu, 920, 6),
            Event(EPILOGUE, gpu, 930, 10),
        ]
        if not drop_fill:
            events.append(Event(FILL, gpu, 520, 9))
    return tracing.reduce_events(events, 2, {}, calls or {})


def _read(name, trace):
    return tracing.load_reader(name).read(trace)


def _call(tests, nbytes_):
    return tracing.Call(torch.tensor(tests, dtype=torch.int64), nbytes_)


def test_probe_ms_takes_the_probes_by_launch_order_and_name():
    t = _trace()
    assert probe_roofline.launches_us(t) == [9 + 200 + 25, 6 + 10]
    want = (9 + 200 + 25 + 6 + 10 + 12 + 8) / 1e3 / 2
    assert _read("probe_ms.step", t) == pytest.approx(want)


def test_a_dropped_fill_is_left_out_of_its_launch():
    t = _trace(drop_fill=True)
    assert probe_roofline.launches_us(t) == [200 + 25, 6 + 10]


def test_probe_roofline_is_the_bound_over_the_mean_launch():
    calls = {probe_roofline.WRAPPER: [_call(10 ** 8, 10 ** 7),
                                      _call(10 ** 5, 10 ** 6),
                                      _call(10 ** 5, 10 ** 6)]}
    want_bound = (bound(10 ** 8 * MT_OPS, 1e7)
                  + 2 * bound(10 ** 5 * MT_OPS, 1e6))
    # Two launches recorded of three calls: the mean times the calls.
    want = 100 * want_bound / ((234 + 16) / 2 * 3 / 1e3)
    assert _read("probe_roofline.step", _trace(calls)) == \
        pytest.approx(want)


def test_the_probe_readers_find_nothing_without_the_probes():
    calls = {probe_roofline.WRAPPER: [_call(10 ** 6, 10 ** 8)]}
    assert _read("probe_ms.step", _trace(calls, probes=False)) is None
    assert _read("probe_roofline.step", _trace(calls, probes=False)) is None
    assert _read("probe_roofline.step", _trace()) is None  # no call


class _Tracer:
    """The part of `tracing.Tracer` that `probe_roofline.install` uses,
    its patches undone by ``monkeypatch``."""

    def __init__(self, monkeypatch):
        self.monkeypatch, self.calls = monkeypatch, []

    def patch(self, module, attr, fn):
        self.monkeypatch.setattr(module, attr, fn)

    def count(self, wrapper, tests, nbytes_):
        self.calls.append((wrapper, int(tests), nbytes_))


def test_install_counts_the_active_rays_tests_at_the_bundle_wrapper(
        monkeypatch):
    """Each listed cluster's triangles for each active ray of its tile,
    at the name `trace_rays` calls; the result passes through."""
    from raytracercuda_torch.trace import bounce_sweep
    from raytracercuda_torch.trace.sweep import TileLists

    tiles, rays, g = 3, 8, 4
    lists = TileLists(ids=torch.zeros(5, dtype=torch.int32),
                      counts=torch.tensor([1, 4, 0], dtype=torch.int32),
                      offsets=torch.tensor([0, 1, 5, 5], dtype=torch.int32))
    active = torch.zeros(tiles, rays, dtype=torch.bool)
    active[0, :2] = True
    active[1, 3:] = True
    o3 = torch.zeros(tiles, 3, rays)
    blocks = torch.zeros(2, g, 9)
    out = tuple(torch.zeros(tiles, rays) for _ in range(4))
    monkeypatch.setattr(bounce_sweep, "_closest_rays_cuda", lambda *a: out)
    tracer = _Tracer(monkeypatch)
    probe_roofline.install(tracer)
    args = (lists, o3, o3, active, blocks, 1e-4)
    assert bounce_sweep._closest_rays_cuda(*args) is out
    assert tracer.calls == [(probe_roofline.WRAPPER, (1 * 2 + 4 * 5) * g,
                             nbytes(*args, out))]


def test_boundary_ms_reads_the_programs_boundary_spans(monkeypatch):
    from raytracercuda_torch.utils import profiler

    monkeypatch.setattr(program, "_last", None)
    profiler.collect()
    with profiler.tracing():
        for _ in range(2):
            with profiler.span("grad"):
                with profiler.span("grad.boundary"):
                    time.sleep(0.002)
    t = _trace()
    rec = program.record(t)
    ns = sum(s.end_ns - s.start_ns for s in rec.spans
             if s.name == "grad.boundary")
    assert _read("boundary_ms.step", t) == pytest.approx(ns / 1e6 / 2)
    assert _read("boundary_ms.step", t) >= 2.0
    # A program that records no such span: nothing to read.
    monkeypatch.setattr(program, "_last", None)
    with profiler.tracing():
        with profiler.span("grad"):
            pass
    assert _read("boundary_ms.step", _trace()) is None
    monkeypatch.setattr(program, "_last", None)
    assert _read("boundary_ms.step", _trace()) is None  # no span at all
