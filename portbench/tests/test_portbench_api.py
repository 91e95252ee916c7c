"""The public-API cell (`loops/api_orbit.py`, `reference/api.py`,
`brute_roofline.py` and its readers) on the CPU: the program's frames
through `Camera.clear` and `Camera.trace_scene` against the reference,
the quad, the control, the faults, the readers on a synthetic profile,
and a kind that the harness finds by its file alone."""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import CPU, ROOT, run_small, small_cell
from portbench import brute_roofline, checks, harness, scenes, tracing
from portbench.faults import faults_of, planted
from portbench.kinds import kind_class
from portbench.reference import api, meshes
from portbench.yardstick import MT_OPS, bound, nbytes
from test_portbench_bounce import Event

CELL = "suzanne15k.brute256.api"


def test_the_kind_lives_in_its_own_file():
    from portbench import kinds

    assert "api_orbit" not in kinds.KINDS
    assert kind_class("api_orbit").__module__.startswith("portbench_kind_")
    assert faults_of("api_orbit") == ("answer", "half")


@pytest.mark.parametrize("pose", [0, 50, 120, 200])
def test_api_frames_equal_the_reference(pose):
    """The program's plain route of `Camera.trace_scene` (kernel E's and
    D's plain versions) reads what the reference reads at every pixel of
    a 32x32 frame, on poses of the cell's own path; one of them sees the
    quad."""
    cell = harness.load_cell(CELL, ROOT)
    config = copy.deepcopy(cell.config)
    config.update(width=32, height=32)
    config["meshes"][0]["faces"] = 500
    kind = kind_class("api_orbit")(config, cell.traffic, 3, CPU)
    got = kind._frame(pose)
    assert not kind.statuses
    scene = scenes.ref_scene(kind.inputs, CPU)
    want = kind._reference(scene, pose, torch.float32)
    assert checks.frame_px_off(got, want) == 0.0
    rays = api.pinhole_rays(32, 32, *kind.lens)
    from portbench.reference import render

    face = api.closest_faces(
        scene.positions, scene.faces, torch.tensor(kind.eyes[pose]),
        render.rotate(rays, torch.tensor(kind.orients[pose])), 1e-4)
    quad_px = int((face >= 500).sum())
    assert (quad_px > 0) == (pose in (50, 200)), quad_px
    assert 0 < int((face >= 0).sum()) < 32 * 32


def test_the_grid_is_the_cameras():
    """`set_initial_rays`' parameters: the top row at ``top``, here -1."""
    rays = api.pinhole_rays(4, 2, -1.0, 1.0, -1.0, 1.0, 1.0)
    assert rays.shape == (8, 3)
    assert torch.allclose(rays.norm(dim=1), torch.ones(8))
    assert (rays[:4, 1] < 0).all() and (rays[4:, 1] > 0).all()
    assert (rays[[0, 4], 0] < 0).all() and (rays[[3, 7], 0] > 0).all()


def test_the_quad_is_the_programs():
    from raytracercuda_torch.models.mesh import (VERTEX_DATA_NORMAL,
                                                 VERTEX_DATA_UV1)
    from raytracercuda_torch.models.procedural import quad_mesh

    mine, theirs = meshes.quad(2.5), quad_mesh(z=2.5)
    assert np.array_equal(mine["positions"], theirs.positions)
    assert np.array_equal(mine["faces"].reshape(-1), theirs.indices)
    assert np.array_equal(mine["normals"],
                          theirs.vertex_data(VERTEX_DATA_NORMAL))
    assert "uvs" not in mine and theirs.vertex_data(VERTEX_DATA_UV1) is None


def test_the_quad_reaches_both_sides_with_zero_uvs():
    config = small_cell(CELL).config
    inputs = scenes.make_inputs(config, 5)
    _, scene = scenes.port_scene(inputs, config, CPU)
    data = scene.data()
    ref = scenes.ref_scene(inputs, CPU)
    nv = len(inputs.meshes[0]["positions"])
    assert torch.equal(data.positions, ref.positions)
    assert torch.equal(data.faces[:, :3], ref.faces)
    assert data.faces.shape[0] == 500 + 2
    assert torch.equal(ref.uvs[nv:], torch.zeros(4, 2))
    assert torch.equal(ref.normals[nv:],
                       torch.tensor([[0.0, 0.0, -1.0]] * 4))


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_control_fails_and_program_passes(seed):
    cell = small_cell(CELL)
    kind = kind_class("api_orbit")(cell.config, cell.traffic, seed, CPU)
    kind.release()
    control = kind.control()
    assert not checks.verdict(control, cell.limits), control
    out = run_small(cell, seed)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["answer", "half"])
def test_a_broken_api_run_is_not_correct(fault):
    cell = small_cell(CELL)
    with planted("api_orbit", fault):
        out = run_small(cell)
    assert not out["correct"], out["checks"]
    assert run_small(cell)["correct"]  # and the fault is gone again


def test_a_status_other_than_0_is_not_correct(monkeypatch):
    from raytracercuda_torch.models.camera import Camera

    cell = small_cell(CELL)
    monkeypatch.setattr(Camera, "clear", lambda self, target, value: 8)
    out = run_small(cell)
    assert not out["correct"]
    assert out["checks"]["px_off"]["value"] == float("inf")


# ---------------------------------------------------------------------------
# A kind found by its file alone.
# ---------------------------------------------------------------------------

STILL = '''
"""A throwaway kind: one number a unit, checked against itself."""
import portbench.checks as checks_module

FAULTS = ("answer",)


class Still:
    def __init__(self, config, traffic, seed, device):
        self.seen = []

    def warm_up(self):
        pass

    def unit(self, i, tracer):
        self.seen.append(checks_module.channels.__name__)

    def end_to_end(self, window_s, latencies):
        return {"frame_ms": window_s / len(latencies) * 1e3,
                "frame_p95_ms": max(latencies) * 1e3}

    def release(self):
        pass

    def check(self):
        return {"px_off": 0.0 if set(self.seen) == {"channels"} else 1.0}

    def notes(self):
        return ""


KIND = Still


def plant(fault):
    def broken(channels):
        def wrong(packed):
            return channels(packed)
        wrong.__name__ = "wrong"
        return wrong
    return checks_module, "channels", broken
'''


def test_a_new_kind_is_a_file_and_entries(tmp_path):
    """A cell whose traffic kind is a new file under ``portbench/loops/``
    runs, with its fault, in a copy where no file that was there
    changed."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = tmp_path / "portbench"
    (bench / "loops" / "still.py").write_text(STILL)
    (bench / "traffic" / "still.json").write_text(
        '{"kind": "still", "trace_units": 2}')
    (bench / "limits" / "suzanne15k.brute256.still.json").write_text(
        '{"px_off": 0.001}')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "suzanne15k.brute256.still",
                              "config": "suzanne15k.brute256",
                              "traffic": "still", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("suzanne15k.brute256.still")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == b for p, b in before.items())
    probe = (
        "import sys, time; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from pathlib import Path\n"
        "import torch\n"
        "from portbench import harness\n"
        "from portbench.faults import faults_of, planted\n"
        "assert harness.__file__.startswith(sys.argv[1])\n"
        "c = harness.load_cell('suzanne15k.brute256.still',\n"
        "                      Path(sys.argv[1]))\n"
        "cpu = torch.device('cpu')\n"
        "out = harness.run(c, 3, 0.2, False, cpu, time.perf_counter())\n"
        "assert out['correct'] and set(out['metrics']) == "
        "{'frame_ms', 'frame_p95_ms', 'setup_s'}, out\n"
        "assert faults_of('still') == ('answer',)\n"
        "with planted('still', 'answer'):\n"
        "    bad = harness.run(c, 3, 0.2, False, cpu, time.perf_counter())\n"
        "assert not bad['correct'], bad\n")
    done = subprocess.run([sys.executable, "-c", probe, str(tmp_path),
                           str(ROOT)], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]


# ---------------------------------------------------------------------------
# The readers.
# ---------------------------------------------------------------------------


def _trace(calls=None, e=True):
    """Two frames: D, then E (its fill, items, epilogue) and the shading,
    the second E's items missing (a scene with no face); A's fill and
    sweep beside them.  Out of time order, as the profiler may give
    them."""
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ns = "void (anonymous namespace)::"
    fill = "fill_keys_kernel(unsigned long long*, long long)"
    events = [
        Event(tracing.WINDOW, cpu, 0, 3000),
        Event(ns + "clear_kernel(unsigned int*, long long)", gpu, 0, 2),
        Event(ns + fill, gpu, 10, 6),  # A's, before A's sweep
        Event(ns + "sweep_items_kernel<false, true>(int const*)", gpu, 20, 70),
        Event("Memcpy HtoD (Pageable -> Device)", gpu, 95, 1),
    ]
    if e:
        events += [
            Event(ns + "brute_items_kernel<4>(float const*)", gpu, 110, 1600),
            Event(ns + fill, gpu, 100, 5),
            Event(ns + "brute_epilogue_kernel(unsigned long long*)", gpu,
                  1720, 20),
            Event("elementwise_kernel", gpu, 1750, 30),
            Event(ns + fill, gpu, 2000, 4),
            Event(ns + "brute_epilogue_kernel(unsigned long long*)", gpu,
                  2010, 10),
        ]
    return tracing.reduce_events(events, 2, {}, calls or {})


def _read(name, trace):
    return tracing.load_reader(name).read(trace)


def _call(tests, nbytes_):
    return tracing.Call(torch.tensor(tests, dtype=torch.int64), nbytes_)


def test_brute_ms_takes_e_and_its_own_fills_alone():
    t = _trace()
    assert brute_roofline.launches_us(t) == [5 + 1600 + 20, 4 + 10]
    assert _read("brute_ms.frame", t) == pytest.approx((1625 + 14) / 2e3)


def test_brute_roofline_is_the_bound_over_the_mean_launch():
    calls = {brute_roofline.WRAPPER: [_call(65536 * 15490, 3 * 10 ** 6)] * 3}
    want_bound = 3 * bound(65536 * 15490 * MT_OPS, 3e6)
    # Two launches recorded of three calls: the mean times the calls.
    want = 100 * want_bound / ((1625 + 14) / 2 * 3 / 1e3)
    assert _read("brute_roofline.frame", _trace(calls)) == \
        pytest.approx(want)
    assert bound(65536 * 15490 * MT_OPS, 3e6) == pytest.approx(0.696970,
                                                               rel=1e-5)


def test_the_e_readers_find_nothing_without_e():
    calls = {brute_roofline.WRAPPER: [_call(10 ** 6, 10 ** 6)]}
    assert _read("brute_ms.frame", _trace(calls, e=False)) is None
    assert _read("brute_roofline.frame", _trace(calls, e=False)) is None
    assert _read("brute_roofline.frame", _trace()) is None  # no call


class _Tracer:
    def __init__(self, monkeypatch):
        self.monkeypatch, self.calls = monkeypatch, []

    def patch(self, module, attr, fn):
        self.monkeypatch.setattr(module, attr, fn)

    def count(self, wrapper, tests, nbytes_):
        self.calls.append((wrapper, int(tests), nbytes_))


def test_install_counts_every_ray_against_every_face(monkeypatch):
    """Rays times faces at E's wrapper, reached through the brute route
    (`trace_brute` picks the wrapper where a CUDA tensor would go), and
    the bytes of the wrapper's inputs and outputs; its result passes
    through."""
    from raytracercuda_torch.trace import bruteforce

    out = (torch.zeros(10), torch.zeros(10), torch.zeros(10),
           torch.zeros(10, dtype=torch.int32))
    monkeypatch.setattr(bruteforce, "_brute_cuda", lambda *a: out)
    monkeypatch.setattr(bruteforce, "_pick", lambda x, plain, cuda: cuda)
    tracer = _Tracer(monkeypatch)
    brute_roofline.install(tracer)
    pos = torch.rand(12, 3)
    faces = torch.tensor([[0, 1, 2, 0], [3, 4, 5, 0], [6, 7, 8, 0]])
    hit = bruteforce.trace_brute(pos, faces, torch.zeros(3),
                                 torch.rand(10, 3))
    assert hit.face is out[3]
    (wrapper, tests, moved), = tracer.calls
    assert (wrapper, tests) == (brute_roofline.WRAPPER, 10 * 3)
    assert moved == nbytes(torch.zeros(10, 3), torch.zeros(10, 3),
                           torch.zeros(9, 3), out)
