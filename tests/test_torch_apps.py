"""The port's TestProgram path: `apps/render_cli.py` and `apps/fly.py`
against the JAX package's, on a textured OBJ written from numpy, and the
utilities they run on (`utils/profiler.py`, `utils/timer.py`,
`utils/png.py`).

Tolerances, stated per check:

  * CLI frames (PNG pixels) on every route: each u8 channel within 1 of
    the JAX CLI's, the bar `tests/test_torch_api.py` holds the API frames
    to and `tests/test_torch_frame.py` the `FrameRenderer` frames (XLA on
    the CPU contracts multiply-adds; the port does not).  The JAX CLI runs
    its Pallas kernels in interpret mode (its CPU default is the XLA
    sweep, which flips near-tie winners).
  * Fly loop: the pose, the render-target rotation and the frame count
    equal JAX's; each frame within 1 per u8 channel.
  * Profiler, timer, PNG: exact.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_parity import assert_u8_close

import raytracercuda_tpu as jrt
from raytracercuda_tpu.apps import fly as jfly
from raytracercuda_tpu.apps import render_cli as jcli
from raytracercuda_tpu.models.procedural import quad_mesh as jax_quad
from raytracercuda_tpu.utils.png import packed_to_rgb8 as jax_rgb8

import raytracercuda_torch as trt
from raytracercuda_torch.apps import fly as tfly
from raytracercuda_torch.apps import render_cli as tcli
from raytracercuda_torch.models.procedural import quad_mesh
from raytracercuda_torch.trace import bruteforce as tbrute
from raytracercuda_torch.trace import sweep as tsweep
from raytracercuda_torch.utils import png as tpng
from raytracercuda_torch.utils import timer
from raytracercuda_torch.utils.profiler import (Profiler, ProfileItem,
                                                device_trace)

from chip_smoke import read_png, write_textured_obj


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_textured_obj(str(tmp_path_factory.mktemp("model")),
                              faces=600, tex_size=16, seed=1)


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX CLI's configs with the Pallas sweep forced (interpret mode
    on the CPU), as `torch_parity.jax_config` makes them."""
    real = jrt.RenderConfig

    def make(accel):
        base = real(accel=accel)
        return dataclasses.replace(base, trace=dataclasses.replace(
            base.trace, use_pallas_sweep=True))

    monkeypatch.setattr(jrt, "RenderConfig", make)


class KernelSpy:
    """Records which kernels' plain versions (the CPU route) the code calls;
    not those one plain version calls inside another (H's runs B's)."""

    NAMES = {tsweep: ("_primary_shade_plain", "_occlusion_plain",
                      "_primary_plain", "_occlusion_rows_plain"),
             tbrute: ("_brute_plain",)}

    def __init__(self, monkeypatch):
        self.calls = set()
        self.depth = 0
        for module, names in self.NAMES.items():
            for name in names:
                monkeypatch.setattr(module, name,
                                    self._wrap(name, getattr(module, name)))

    def _wrap(self, name, fn):
        def run(*args):
            if self.depth == 0:
                self.calls.add(name.removeprefix("_").removesuffix("_plain"))
            self.depth += 1
            try:
                return fn(*args)
            finally:
                self.depth -= 1
        return run


# (shading, accel, size, the kernels whose plain versions the route runs)
CLI_CASES = {
    "parity_brute_32": ("parity", "brute", 32, {"brute"}),
    "parity_cluster_40": ("parity", "cluster", 40, {"primary"}),
    "lambert_cluster_32": ("lambert", "cluster", 32, {"primary_shade"}),
    "lambert_shadow_cluster_48": ("lambert-shadow", "cluster", 48,
                                  {"primary_shade", "occlusion"}),
    "lambert_shadow_cluster_40": ("lambert-shadow", "cluster", 40,
                                  {"primary", "occlusion_rows"}),
    "lambert_shadow_brute_32": ("lambert-shadow", "brute", 32, {"brute"}),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_render_cli_matches_jax(case, model, tmp_path, jax_pallas,
                                monkeypatch):
    shading, accel, size, kernels = CLI_CASES[case]
    argv = [model, "--size", str(size), "--accel", accel, "--shading",
            shading, "--frames", "2", "--orbit", "20", "--zoom", "2.5"]
    assert jcli.main(argv + ["-o", str(tmp_path / "jax")]) == 0
    spy = KernelSpy(monkeypatch)
    assert tcli.main(argv + ["-o", str(tmp_path / "port"), "--device",
                             "cpu"]) == 0
    assert spy.calls == kernels
    assert trt.RenderTarget.get() is None  # unlocked at the end
    for frame in range(2):
        name = f"frame_{frame:04d}.png"
        got = read_png(tmp_path / "port" / name).astype(np.int64)
        want = read_png(tmp_path / "jax" / name).astype(np.int64)
        assert got.shape == (size, size, 3)
        assert np.abs(got - want).max() <= 1, name
        assert (want != want[0, 0]).any(axis=-1).mean() > 0.1  # in view


def test_render_cli_unlocks_when_a_frame_fails(model, tmp_path, monkeypatch):
    def fail(*args):
        raise OSError("disk full")

    monkeypatch.setattr(tpng, "write_packed_png", fail)
    with pytest.raises(OSError, match="disk full"):
        tcli.main([model, "--size", "16", "--accel", "brute", "-o",
                   str(tmp_path), "--device", "cpu"])
    assert trt.RenderTarget.get() is None


def test_render_cli_backends_and_errors(model, tmp_path, capsys):
    for accel in ("bvh", "wavefront"):
        out = tmp_path / accel
        assert tcli.main([model, "--accel", accel, "--size", "16", "-o",
                          str(out), "--device", "cpu"]) == 0
        frame = read_png(out / "frame_0000.png")
        assert frame.shape == (16, 16, 3)
        assert (frame != frame[0, 0]).any()  # the model is in view
    for shading in ("parity", "lambert"):  # through kernel M's march
        out = tmp_path / f"grid_{shading}"
        assert tcli.main([model, "--accel", "grid", "--shading", shading,
                          "--size", "16", "-o", str(out),
                          "--device", "cpu"]) == 0
        frame = read_png(out / "frame_0000.png")
        assert frame.shape == (16, 16, 3)
        assert (frame != frame[0, 0]).any()
    # No shadows on GRID, as in the JAX package (`render_rgb`).
    with pytest.raises(NotImplementedError, match="GRID"):
        tcli.main([model, "--accel", "grid", "--shading", "lambert-shadow",
                   "--size", "16", "-o", str(tmp_path), "--device", "cpu"])
    assert trt.RenderTarget.get() is None
    assert tcli.main([str(tmp_path / "none.obj"), "-o", str(tmp_path),
                      "--device", "cpu"]) == 1
    assert "model not found" in capsys.readouterr().err
    assert tcli.build_parser().parse_args([model]).device == "cuda"


def test_render_cli_profile(model, tmp_path, capsys):
    assert tcli.main([model, "--size", "16", "--accel", "brute",
                      "--profile", "-o", str(tmp_path), "--device",
                      "cpu"]) == 0
    out = capsys.readouterr().out
    assert "--- Profile Items ---" in out
    for phase in ("Scene", "Trace", "Present"):
        assert f"\n{phase}\t" in out


# ---------------------------------------------------------------------------
# The fly loop.
# ---------------------------------------------------------------------------


def test_flystate_reference_semantics():
    s = tfly.FlyState(np.zeros(3))
    s.feed({"event": "keydown", "key": "w"})
    s.update()
    # pan=pitch=0 -> orient = I; w pushes +z by SPEED.
    np.testing.assert_allclose(s.pos, [0, 0, tfly.SPEED], atol=1e-6)
    s.feed({"event": "mouse", "xrel": 100, "yrel": -50})
    assert np.isclose(s.pan, 100 * tfly.MSPEED)
    assert np.isclose(s.pitch, -50 * tfly.MSPEED)
    s.feed({"event": "keyup", "key": "w"})
    s.feed({"event": "keydown", "key": "q"})
    p1 = s.pos[1]
    s.update()
    assert np.isclose(s.pos[1], p1 + tfly.SPEED)  # q is world-space +y
    s.feed({"event": "keydown", "key": "escape"})
    assert s.quit
    assert (tfly.KEYS, tfly.SPEED, tfly.MSPEED, tfly.NUM_RT) == \
        (jfly.KEYS, jfly.SPEED, jfly.MSPEED, jfly.NUM_RT)


def test_flystate_matches_jax():
    events = [{"event": "keydown", "key": k} for k in "wdq"] + [
        {"event": "mouse", "xrel": 37, "yrel": -11},
        {"event": "keyup", "key": "w"}, {"event": "keydown", "key": "a"},
        {"event": "keydown", "key": "s"}, {"event": "keydown", "key": "e"}]
    t, j = tfly.FlyState([1, 2, 3], 0.2, -0.1), jfly.FlyState([1, 2, 3], 0.2,
                                                              -0.1)
    for ev in events:
        t.feed(ev)
        j.feed(ev)
        np.testing.assert_array_equal(t.update(), j.update())
        np.testing.assert_array_equal(t.pos, j.pos)
    assert (t.pan, t.pitch, t.kds) == (j.pan, j.pitch, j.kds)


SCRIPT = [{"frame": 0, "event": "keydown", "key": "s"},
          {"frame": 2, "event": "keyup", "key": "s"},
          {"frame": 2, "event": "mouse", "xrel": 30, "yrel": 0},
          {"frame": 4, "event": "quit"}]


def fly_run(pkg, fly, proc_quad, script_path, **kw):
    """`tests/test_fly.py`'s run: the quad at z = 2.5 on BRUTE, 32x32, three
    render targets."""
    scene = pkg.Scene.create(pkg.RenderConfig(accel=pkg.AccelKind.BRUTE),
                             **kw)
    scene.add_mesh(proc_quad(z=2.5))
    scene.update_gpu_scene()
    cam = pkg.Camera.create(**kw)
    assert cam.set_initial_rays(32, 32, -1, 1, -1, 1, 1) == 0
    rts = [pkg.RenderTarget.create(32, 32, **kw) for _ in range(3)]
    assert rts[0].lock() == 0
    seen = []
    state = fly.FlyState(np.array([0, 0, -1.0], np.float32))
    n = fly.run_loop(scene, cam, rts, state, fly._load_script(script_path),
                     max_frames=10, out_dir=None,
                     on_frame=lambda f, s, i, buf: seen.append(
                         (f, i, np.array(buf))))
    return n, state, rts, seen


def test_run_loop_matches_jax(tmp_path):
    script = tmp_path / "script.jsonl"
    script.write_text("# replay\n" + "\n".join(json.dumps(e)
                                               for e in SCRIPT))
    n, state, rts, seen = fly_run(trt, tfly, quad_mesh, str(script),
                                  device="cpu")
    jn, jstate, _, jseen = fly_run(jrt, jfly, jax_quad, str(script))
    # tests/test_fly.py's expectations.
    assert n == jn == 4  # the quit event at frame 4 stops before rendering
    assert np.isclose(state.pos[2], -1.0 - 2 * tfly.SPEED)
    assert state.pan > 0
    assert [i for _, i, _ in seen] == [i for _, i, _ in jseen] == [1, 2, 0,
                                                                   1]
    assert all(not r.locked for r in rts)
    bg = 255 << 8
    assert any((buf != bg).any() for _, _, buf in seen)
    # And JAX's own, frame by frame.
    np.testing.assert_array_equal(state.pos, jstate.pos)
    assert state.pan == jstate.pan
    for (f, _, got), (jf, _, want) in zip(seen, jseen):
        assert f == jf
        assert got.dtype == want.dtype == np.uint32
        assert_u8_close(got, want)


def test_fly_main(model, tmp_path):
    script = tmp_path / "script.jsonl"
    script.write_text(json.dumps({"frame": 1, "event": "keydown",
                                  "key": "w"}) + "\n")
    out = tmp_path / "frames"
    # The default structure, BVH, as the JAX package's.
    built = []
    real = trt.Scene.update_gpu_scene

    def update(scene):
        built.append(scene.config.accel)
        return real(scene)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trt.Scene, "update_gpu_scene", update)
        assert tfly.main(["--model", model, "--script", str(script),
                          "--frames", "3", "--size", "16", "--out", str(out),
                          "--device", "cpu"]) == 0
    assert built and set(built) == {trt.AccelKind.BVH}
    assert sorted(os.listdir(out)) == [f"fly_{i:04d}.png" for i in range(3)]
    frame = read_png(out / "fly_0002.png")
    assert frame.shape == (16, 16, 3)
    assert (frame != frame[0, 0]).any()  # the model is in view
    assert trt.RenderTarget.get() is None
    grid_out = tmp_path / "grid"
    assert tfly.main(["--model", model, "--script", str(script), "--accel",
                      "grid", "--frames", "3", "--size", "16", "--out",
                      str(grid_out), "--device", "cpu"]) == 0
    assert sorted(os.listdir(grid_out)) == [f"fly_{i:04d}.png"
                                            for i in range(3)]
    assert (read_png(grid_out / "fly_0002.png") != frame[0, 0]).any()


# ---------------------------------------------------------------------------
# Profiler, timer, PNG.
# ---------------------------------------------------------------------------


def test_profiler_report(capsys):
    prof = Profiler(interval=3600.0)
    with prof.phase("Scene"):
        pass
    with prof.phase("Trace", sync=[torch.zeros(2), torch.ones(1)]):
        pass
    prof.push(ProfileItem("Present", start=timer.abs_time()))
    assert [i.name for i in prof.items] == ["Scene", "Trace", "Present"]
    assert all(i.elapsed_ms >= 0.0 for i in prof.items)
    out = prof.report(force=True)
    assert out.splitlines()[0] == "--- Profile Items ---"
    assert [line.split("\t")[0] for line in out.splitlines()[1:]] == \
        ["Scene", "Trace", "Present"]
    assert capsys.readouterr().out == out + "\n"
    assert prof.items == []
    with prof.phase("Again"):
        pass
    assert prof.report() is None  # inside the interval: dropped
    assert prof.items == []


def test_device_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_timer():
    first = timer.run_time()
    assert 0.0 <= first
    a = timer.abs_time()
    assert timer.time() >= first and timer.timeD() >= first
    assert timer.abs_time() >= a
    assert timer.time is timer.run_time and timer.timeD is timer.run_time


def test_png_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 1 << 24, 6 * 5, dtype=np.int64)
    got = tpng.packed_to_rgb8(torch.from_numpy(packed))
    np.testing.assert_array_equal(got, jax_rgb8(packed.astype(np.uint32)))
    tpng.write_packed_png(str(tmp_path / "a.png"), torch.from_numpy(packed),
                          6, 5)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"),
                                  got.reshape(5, 6, 3))
