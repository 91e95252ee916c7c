"""The LBVH cell's readers (`bvh_ms.frame`, `beam_roofline.frame`,
`walk_any_roofline.frame`, `portbench/lbvh_roofline.py`) on a synthetic
profile, the bytes they count at the program's wrappers, and the cell
itself, shrunk, on the CPU."""

from __future__ import annotations

import copy

import pytest
import torch

from conftest import ROOT, run_small
from portbench import harness, lbvh_roofline, tracing
from portbench.yardstick import bound

from raytracercuda_torch.accel.bvh import build_bvh
from raytracercuda_torch.trace import beam, traverse

CELL = "bunny69k.bvh512.near"


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


def _trace(calls=None):
    """Two frames: L's walk and test twice (two rounds) and its epilogue,
    K's any hit, and a closest-hit walk and a sweep kernel beside them."""
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ns = "void (anonymous namespace)::"
    events = [
        Event(tracing.WINDOW, cpu, 0, 1000),
        Event(ns + "beam_walk_kernel(float4 const*, int)", gpu, 0, 40),
        Event(ns + "beam_test_kernel(float4 const*)", gpu, 40, 60),
        Event(ns + "beam_walk_kernel(float4 const*, int)", gpu, 100, 20),
        Event(ns + "beam_test_kernel(float4 const*)", gpu, 120, 30),
        Event(ns + "beam_epilogue_kernel(float const*)", gpu, 150, 10),
        Event(ns + "walk_kernel<true>(float4 const*, int)", gpu, 200, 50),
        Event(ns + "walk_kernel<false>(float4 const*, int)", gpu, 300, 25),
        Event(ns + "sweep_items_kernel<false, true>(int const*)", gpu, 400,
              70),
    ]
    return tracing.reduce_events(events, 2, {}, calls or {})


def _read(name, trace):
    return tracing.load_reader(name).read(trace)


def _call(nbytes):
    return tracing.Call(torch.zeros((), dtype=torch.int64), nbytes)


def test_bvh_ms_sums_l_and_k_by_name():
    t = _trace()
    # L: 40 + 60 + 20 + 30 + 10; K: 50 + 25; not the sweep.
    assert _read("bvh_ms.frame", t) == pytest.approx((160 + 75) / 2e3)


@pytest.mark.parametrize("name,wrapper,kernel_us", [
    ("beam_roofline.frame", "_beam_cuda", 160),
    ("walk_any_roofline.frame", "_walk_any_cuda", 50)])
def test_shares_are_the_bytes_bound_over_every_launch(name, wrapper,
                                                      kernel_us):
    assert _read(name, _trace()) is None  # no call counted
    calls = {wrapper: [_call(10 ** 8), _call(3 * 10 ** 8)]}
    want = 100 * (bound(0, 1e8) + bound(0, 3e8)) / (kernel_us / 1e3)
    assert _read(name, _trace(calls)) == pytest.approx(want)


def test_readers_find_nothing_without_their_kernels():
    t = tracing.reduce_events(
        [Event(tracing.WINDOW, torch.autograd.DeviceType.CPU, 0, 1000)], 2,
        {}, {"_beam_cuda": [_call(10 ** 6)],
             "_walk_any_cuda": [_call(10 ** 6)]})
    for name in ("bvh_ms.frame", "beam_roofline.frame",
                 "walk_any_roofline.frame"):
        assert _read(name, t) is None


class _Tracer:
    """The part of `tracing.Tracer` that `lbvh_roofline.install` uses,
    its patches undone by ``monkeypatch``."""

    def __init__(self, monkeypatch):
        self.monkeypatch, self.calls = monkeypatch, {}

    def patch(self, module, attr, fn):
        self.monkeypatch.setattr(module, attr, fn)

    def count(self, wrapper, tests, nbytes):
        self.calls.setdefault(wrapper, []).append(nbytes)


def test_install_counts_the_tensors_each_wrapper_hands_its_kernel(
        monkeypatch):
    """The packed nodes, links and triangles, the rays, the planes or
    ``t_max``, and the outputs, each once, at the wrappers the frame
    calls; the wrappers' own results pass through."""
    g = torch.Generator().manual_seed(4)
    positions = torch.rand(90, 3, generator=g)
    faces = torch.cat([torch.randperm(90, generator=g)[:90].reshape(30, 3),
                       torch.zeros(30, 1, dtype=torch.int64)], dim=1)
    bvh = build_bvh(positions, faces)
    rays, tiles = 64, 4
    outs = (torch.zeros(rays), torch.zeros(rays), torch.zeros(rays),
            torch.zeros(rays, dtype=torch.int32))
    occluded = torch.zeros(rays, dtype=torch.bool)
    monkeypatch.setattr(beam, "_beam_cuda", lambda *a, **kw: outs)
    monkeypatch.setattr(traverse, "_walk_any_cuda", lambda *a, **kw: occluded)
    tracer = _Tracer(monkeypatch)
    lbvh_roofline.install(tracer)
    eye, dirs = torch.zeros(3), torch.zeros(rays, 3)
    planes = torch.zeros(tiles, 5, 3)
    t_max = torch.zeros(rays)
    assert beam._beam_cuda(bvh, eye, dirs, planes, 8, 8, 4, 128, 16, 4096,
                           None, 32) is outs
    assert traverse._walk_any_cuda(bvh, dirs, dirs, t_max, 4096,
                                   1e-4) is occluded
    tree = (bvh.packed_nodes.numel() * 4 + bvh.packed_links.numel() * 4
            + bvh.packed_tris.numel() * 4)
    assert tracer.calls == {
        "_beam_cuda": [tree + 12 + rays * 12 + tiles * 60 + rays * 16],
        "_walk_any_cuda": [tree + 2 * rays * 12 + rays * 4 + rays]}


def test_the_cell_runs_correct_on_the_cpu():
    """The cell from its files, at 2,000 faces and 48x48 with a short
    period (as `conftest.small_cell` shrinks the others), on the plain
    versions: ``correct``."""
    cell = harness.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config["accel"] == "bvh"
    assert {m["name"] for m in cell.end_to_end} == {"frame_ms",
                                                    "frame_p95_ms",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "idle_share.frame", "launches.frame", "host_syncs.frame",
        "sync_wait_ms.frame", "glue_idle_ms.frame", "bvh_ms.frame",
        "beam_roofline.frame", "walk_any_roofline.frame"}
    config = copy.deepcopy(cell.config)
    config["meshes"][0]["faces"] = 2000
    config["width"] = config["height"] = 48
    traffic = dict(cell.traffic, period=4, pan_deg_per_frame=90.0,
                   checked_frames=2, warmup_frames=1, trace_units=4)
    out = run_small(cell._replace(config=config, traffic=traffic))
    assert out["correct"] and out["device"]["platform"] == "cpu"
    assert out["checks"]["px_off"]["value"] <= 0.001
