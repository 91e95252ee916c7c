"""The per-layer readers on a synthetic profile."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT
from portbench import roofline, tracing
from portbench.yardstick import MT_OPS, bound


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


def _trace(calls=None, spans=None):
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    a = "void (anonymous namespace)::sweep_items_kernel<false, true>(int const*)"
    events = [
        Event(tracing.WINDOW, cpu, 0, 1000),
        Event(tracing.WINDOW, gpu, 0, 1000),  # the annotation's device copy
        Event("cudaStreamSynchronize", cpu, 150, 100),
        Event("aten::nonzero", cpu, 100, 300),
        Event("fill_keys_kernel(unsigned long long*, long long)", gpu, 0, 50),
        Event(a, gpu, 40, 60),  # overlaps the fill: busy 0-100
        Event("shade_epilogue_kernel<false>(float*)", gpu, 300, 100),
        Event(a, gpu, 600, 100),
        Event("Memset (Device)", gpu, 990, 20),  # runs past the window
    ]
    return tracing.reduce_events(events, 2, spans or {}, calls or {})


def test_union_window_and_gaps():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((100 + 100 + 100 + 10) * 1e-6)
    names = dict(tracing.breakdown(t)["idle_gaps"])
    # The gap 100-300 has the host in a sync inside nonzero at its middle.
    assert names["cudaStreamSynchronize"] == pytest.approx(200e-6)
    assert names["python"] == pytest.approx((200 + 290) * 1e-6)
    ops = dict(tracing.breakdown(t)["device_ops"])
    assert ops["sweep_items_kernel<false, true>"] == pytest.approx(160e-6)


def _read(name, trace):
    return tracing.load_reader(name).read(trace)


def test_readers():
    t = _trace(spans={"backward": [2.0, 4.0], "rebuild": [1.0]})
    assert _read("idle_share.frame", t) == pytest.approx(69.0)
    assert _read("idle_share.step", t) == pytest.approx(69.0)
    assert _read("launches.frame", t) == pytest.approx(2.5)
    assert _read("sweep_ms.frame", t) == pytest.approx((50 + 160 + 100) / 2e3)
    assert _read("scatter_ms.step", t) is None
    assert _read("backward_ms.step", t) == pytest.approx(3.0)
    assert _read("rebuild_ms.step", t) == pytest.approx(1.0)
    assert _read("closest_roofline.frame", t) is None  # no call counted


def test_roofline_counts_each_kernel_per_call():
    calls = {"_primary_shade_cuda": [
        tracing.Call(torch.tensor(10 ** 9), 10 ** 6),
        tracing.Call(torch.tensor(10 ** 9), 10 ** 6)]}
    t = _trace(calls=calls)
    # Two calls; each kernel's mean recorded time a call: 50 + 80 + 100 us.
    want = 100 * 2 * bound(1e9 * MT_OPS, 1e6) / (2 * 0.230)
    assert _read("closest_roofline.frame", t) == pytest.approx(want)
    assert roofline.share(t, "_primary_cuda") is None


def test_every_metric_has_a_reader_and_its_cells_exist():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert callable(tracing.load_reader(m["name"]).read), m["name"]
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
