"""The two tile culls, `sweep.frustum_cull` (before kernels A and C) and
`sweep.beam_cull` (before B and H), each one kernel launch on the card
(`csrc/cull.cu`) in place of a chain of PyTorch ops.

On the CPU: the wrappers run the plain chains unchanged, in both layouts
and on the edge cases (a tile with no active ray, the eye inside a
cluster box, a degenerate corner pair, one cluster, a 1024x1024 frame's
tiles over the armadillo's cluster count); the four entry points hand
`_tile_lists` their cull's mask and their sweep its lists, the shadow
sweeps along `light_basis`'s unit light; a frame, a pass and a step cull
once of each kind.

The tests marked ``card`` need an NVIDIA GPU and skip without one; on the
card: ``python -m pytest tests/test_torch_cull.py -m card -s
--noconftest`` (this file imports no jax; ``-s`` shows the counts of
differing mask entries).  On the card every mask entry that differs
from the chain's must lie within `chip_smoke.CULL_THRESHOLD_REL` of its
test's threshold.

The card tests also hold the sweeps the culls feed, A and B in a frame, C
and H in a progressive pass and H on ray bundles: each launch's staged eye
or light rows and its outputs bit-equal to the plain versions', and the
staged tables counted once a launch of A, B, C or H and never on F's
sweep."""

from __future__ import annotations

import contextlib
import json
import math
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (CULL_THRESHOLD_REL, beam_margin, bits_equal,
                        frustum_margin, staged_counts, staged_rows_check)
from raytracercuda_torch.diff import render_grad
from raytracercuda_torch.models.camera import (camera_ray_grid,
                                               orient_from_pan_pitch)
from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
from raytracercuda_torch.models.scene import Material, Scene
from raytracercuda_torch.trace import sweep
from raytracercuda_torch.trace.dense import (_cull_frustum,
                                             tile_frustum_planes,
                                             tile_pixels_planar)
from raytracercuda_torch.trace.frame import FrameRenderer
from raytracercuda_torch.trace.occlusion_cull import (
    swept_tile_beams, swept_tile_beams_planar)
from raytracercuda_torch.trace.progressive import (init_progressive,
                                                   progressive_step)
from raytracercuda_torch.trace.shadow import light_basis
from test_torch_tracing import CONFIG, Small, _sync_sites

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TP = 16
R = TP * TP
LAYOUTS = ["planar", "rows"]
#: The armadillo configuration's cluster count at 128 faces a cluster,
#: and a 1024x1024 frame's 16-pixel tiles.
ARMADILLO_CLUSTERS = 2735
FRAME_1024_TILES = 4096


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


# ---------------------------------------------------------------------------
# Cases.
# ---------------------------------------------------------------------------


def planar_dirs(small) -> torch.Tensor:
    """``[T, 3, R]`` directions of a `Small` frame, as `FrameRenderer`
    makes them."""
    r = small.rays.T
    o = small.orient
    d3 = o[:, 0:1] * r[0] + o[:, 1:2] * r[1] + o[:, 2:3] * r[2]
    return tile_pixels_planar(d3, small.side, small.side, TP).contiguous()


def small_boxes(count: int, seed: int):
    """``count`` boxes of 0.02-0.1 half-extent scattered ahead of the eye."""
    rng = np.random.default_rng(seed)
    mid = rng.uniform((-4.0, -4.0, 1.5), (4.0, 4.0, 10.0), (count, 3))
    half = rng.uniform(0.02, 0.1, (count, 3))
    return (torch.from_numpy((mid - half).astype(np.float32)),
            torch.from_numpy((mid + half).astype(np.float32)))


def frustum_case(case: str):
    """``(planar [T, 3, R] directions, eye [3], cmin, cmax [C, 3])``."""
    if case == "frame_1024_armadillo_clusters":
        rays = camera_ray_grid(1024, 1024, device="cpu")
        d = tile_pixels_planar(rays.T.contiguous(), 1024, 1024, TP)
        cmin, cmax = small_boxes(ARMADILLO_CLUSTERS, 7)
        assert d.shape[0] == FRAME_1024_TILES
        return d.contiguous(), torch.zeros(3), cmin, cmax
    s = Small(faces=3000, side=64)
    d, eye = planar_dirs(s), s.eye
    cmin, cmax = s.accel.cmin, s.accel.cmax
    if case == "eye_inside_a_box":
        eye = (cmin[5] + cmax[5]) * 0.5
    elif case == "degenerate_corners":
        d = d.clone()
        d[0, :, TP - 1] = d[0, :, 0]  # c01 == c00: a zero normal, sign 0
    elif case == "one_cluster":
        cmin, cmax = cmin[:1], cmax[:1]
    return d, eye, cmin, cmax


def beam_case(case: str):
    """``(planar [T, 3, R] origins, [T, R] bool active, light [3], cmin,
    cmax [C, 3])``; tile 3 has no active ray."""
    big = case == "frame_1024_armadillo_clusters"
    rng = np.random.default_rng(11)
    tiles = FRAME_1024_TILES if big else 16
    centre = rng.uniform((-1.0, -1.0, 2.0), (1.0, 1.0, 4.0), (tiles, 3))
    o = (rng.standard_normal((tiles, 3, R)) * 0.1
         + centre[:, :, None]).astype(np.float32)
    act = rng.random((tiles, R)) < 0.3
    act[3] = False
    light = np.asarray([0.4, 0.8, -0.45], np.float32)
    if big:
        cmin, cmax = small_boxes(ARMADILLO_CLUSTERS, 8)
    else:
        accel = Small(faces=3000, side=16).accel
        cmin, cmax = accel.cmin, accel.cmax
    if case == "origins_inside_a_box":
        lo, hi = cmin[5].numpy(), cmax[5].numpy()
        o[0] = rng.uniform(lo, hi, (R, 3)).T
        act[0] = True
    elif case == "light_near_x_one_ray":
        light = np.asarray([0.95, 0.1, -0.3], np.float32)  # |l0| >= 0.9
        act[1] = False
        act[1, 17] = True  # the box of one origin, a point, in box 5
        o[1, :, 17] = ((cmin[5] + cmax[5]) * 0.5).numpy()
    elif case == "one_cluster":
        cmin, cmax = cmin[:1], cmax[:1]
    return (torch.from_numpy(o), torch.from_numpy(act),
            torch.from_numpy(light), cmin, cmax)


FRUSTUM_CASES = ["frame", "eye_inside_a_box", "degenerate_corners",
                 "one_cluster", "frame_1024_armadillo_clusters"]
BEAM_CASES = ["frame", "origins_inside_a_box", "light_near_x_one_ray",
              "one_cluster", "frame_1024_armadillo_clusters"]


def in_layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    """Planar ``[T, 3, R]`` tiles in ``layout``."""
    return x if layout == "planar" else x.transpose(1, 2).contiguous()


def frustum_chain(d, eye, cmin, cmax, planar: bool) -> torch.Tensor:
    """The frustum cull as the entry points ran it before the kernel."""
    planes = (sweep.tile_planes_planar(d, TP) if planar
              else tile_frustum_planes(d, TP))
    return _cull_frustum(planes, eye, cmin, cmax)


def beam_chain(o, act, light, cmin, cmax, planar: bool):
    """The swept-beam cull as the entry points ran it before the kernel:
    ``(mask, beam)``."""
    beam = (swept_tile_beams_planar if planar else swept_tile_beams)(
        o, act, light)
    return sweep.beam_survive_matrix(beam, cmin, cmax), beam


# ---------------------------------------------------------------------------
# On the CPU.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", FRUSTUM_CASES)
def test_frustum_cull_runs_the_chain_on_the_cpu(case, layout):
    d3, eye, cmin, cmax = frustum_case(case)
    d = in_layout(d3, layout)
    planar = layout == "planar"
    want = frustum_chain(d, eye, cmin, cmax, planar)
    got = sweep.frustum_cull(d.clone().requires_grad_(), eye, cmin, cmax,
                             TP, planar)
    assert got.dtype == torch.bool and got.grad_fn is None
    assert torch.equal(got, want)
    assert want.any()
    if cmin.shape[0] > 1:
        assert not want.all()
    if case == "eye_inside_a_box":
        assert want[:, 5].all()
    if case == "degenerate_corners":  # a zero plane, which every box passes
        assert not sweep.tile_planes_planar(d3, TP)[0, 0].any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", BEAM_CASES)
def test_beam_cull_runs_the_chain_on_the_cpu(case, layout):
    o, act, light, cmin, cmax = beam_case(case)
    o = in_layout(o, layout)
    planar = layout == "planar"
    want, beam = beam_chain(o, act, light, cmin, cmax, planar)
    got = sweep.beam_cull(o.clone().requires_grad_(), act, light, cmin,
                          cmax, planar)
    assert got.dtype == torch.bool and got.grad_fn is None
    assert torch.equal(got, want)
    assert not want[3].any() and want.any()
    if case == "origins_inside_a_box":
        assert want[0, 5]
    if case == "light_near_x_one_ray":
        assert beam.l[0].abs() >= 0.9 and want[1, 5]


@pytest.mark.parametrize("wrong", ["keeps_all", "keeps_none"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["frustum", "beam"])
def test_the_card_gate_refuses_a_mask_off_its_thresholds(kind, layout,
                                                          wrong):
    """`chip_smoke`'s and the card tests' gate: a kernel mask that keeps
    every cluster, or none, differs from the chain at tests far from their
    thresholds."""
    if kind == "frustum":
        d, eye, cmin, cmax = frustum_case("frame")
        args = (in_layout(d, layout), eye, cmin, cmax, TP,
                layout == "planar")
        want, margin = sweep._frustum_cull_plain(*args), frustum_margin
    else:
        o, act, light, cmin, cmax = beam_case("frame")
        args = (in_layout(o, layout), act, light, cmin, cmax,
                layout == "planar")
        want, margin = sweep._beam_cull_plain(*args), beam_margin
    got = torch.full_like(want, wrong == "keeps_all")
    bad = (got != want).nonzero()
    assert len(bad)
    assert margin(*args, bad[:, 0], bad[:, 1]).max() > CULL_THRESHOLD_REL


class Seen:
    """Records, during a call of an entry point, the cull's mask, the mask
    `_tile_lists` compacts, and the lists and the other arguments the
    sweep receives."""

    def __init__(self, monkeypatch, cull: str, plain: str):
        self.masks, self.compacted, self.swept, self.args = [], [], [], []
        real_cull, real_lists = getattr(sweep, cull), sweep._tile_lists
        real_plain = getattr(sweep, plain)

        def cull_fn(*args, **kw):
            out = real_cull(*args, **kw)
            self.masks.append(out)
            return out

        def lists_fn(survive):
            self.compacted.append(survive)
            return real_lists(survive)

        def plain_fn(lists, *args):
            self.swept.append(lists)
            self.args.append(args)
            return real_plain(lists, *args)

        monkeypatch.setattr(sweep, cull, cull_fn)
        monkeypatch.setattr(sweep, "_tile_lists", lists_fn)
        monkeypatch.setattr(sweep, plain, plain_fn)


def assert_lists_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


ENTRY_POINTS = ["trace_shade_tiles_planar", "occlusion_tiles_planar",
                "trace_tiles", "occlusion_tiles"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_sweeps_the_lists_of_its_cull(entry, monkeypatch):
    s = Small(faces=3000, side=64)
    cs = s.accel
    d3 = planar_dirs(s)
    o3, act, light, _, _ = beam_case("frame")
    geom = sweep.segment_blocks(cs)
    if entry == "trace_shade_tiles_planar":
        blocks, has_uv = sweep.shade_segment_blocks(cs, s.data)
        want_mask = frustum_chain(d3, s.eye, cs.cmin, cs.cmax, True)
        want = sweep._primary_shade_plain(
            sweep._tile_lists(want_mask), s.eye, d3, blocks, has_uv, False,
            sweep.t_eps_of(sweep.TraceConfig()))
        seen = Seen(monkeypatch, "frustum_cull", "_primary_shade_plain")
        got = sweep.trace_shade_tiles_planar(cs, blocks, has_uv, s.eye, d3)
    elif entry == "trace_tiles":
        rows = d3.transpose(1, 2).contiguous()
        want_mask = frustum_chain(rows, s.eye, cs.cmin, cs.cmax, False)
        bt, bu, bv, _ = sweep._primary_plain(
            sweep._tile_lists(want_mask), s.eye, rows, geom,
            sweep.t_eps_of(sweep.TraceConfig()))
        want = (bt.reshape(-1), bu.reshape(-1), bv.reshape(-1))
        seen = Seen(monkeypatch, "frustum_cull", "_primary_plain")
        hit = sweep.trace_tiles(cs, geom, s.eye, rows)
        got = (hit.t, hit.u, hit.v)
    else:
        planar = entry == "occlusion_tiles_planar"
        o = in_layout(o3, "planar" if planar else "rows")
        want_mask, beam = beam_chain(o, act, light, cs.cmin, cs.cmax, planar)
        eps = np.float32(sweep.TraceConfig().t_epsilon)
        lists = sweep._tile_lists(want_mask)
        if planar:
            want = sweep._occlusion_plain(lists, beam.l, o, act, geom,
                                          eps) & act
            seen = Seen(monkeypatch, "beam_cull", "_occlusion_plain")
            got = sweep.occlusion_tiles_planar(cs, o, light, act)
        else:
            want = (sweep._occlusion_rows_plain(lists, beam.l, o, act, geom,
                                                eps) & act).reshape(-1)
            seen = Seen(monkeypatch, "beam_cull", "_occlusion_rows_plain")
            got = sweep.occlusion_tiles(cs, geom, o, light, act)
    assert len(seen.masks) == len(seen.swept) == 1
    assert seen.compacted[-1] is seen.masks[0]
    assert torch.equal(seen.masks[0], want_mask)
    assert_lists_equal(seen.swept[0], sweep._tile_lists(want_mask))
    assert 0 < int(seen.swept[0].counts.sum()) < want_mask.numel()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("light", [(0.4, 0.8, -0.45), (0.95, 0.1, -0.3),
                                   (-3.0, 0.5, 2.0), (0.0, 0.0, 1.0)])
@pytest.mark.parametrize("entry", ["occlusion_tiles_planar",
                                   "occlusion_tiles"])
def test_shadow_sweep_runs_along_light_basis_l(entry, light, monkeypatch):
    """B and H sweep along `light_basis`'s unit l, bit for bit, for lights
    on both sides of its axis switch and of any length."""
    cs = Small(faces=800, side=16).accel
    o3, act, _, _, _ = beam_case("frame")
    planar = entry == "occlusion_tiles_planar"
    o = in_layout(o3, "planar" if planar else "rows")
    light_dir = torch.tensor(light)
    plain = "_occlusion_plain" if planar else "_occlusion_rows_plain"
    seen = Seen(monkeypatch, "beam_cull", plain)
    if planar:
        sweep.occlusion_tiles_planar(cs, o, light_dir, act)
    else:
        sweep.occlusion_tiles(cs, sweep.segment_blocks(cs), o, light_dir,
                              act)
    swept_light = seen.args[0][0]
    assert swept_light.dtype == torch.float32
    assert torch.equal(swept_light, light_basis(light_dir)[2])


@contextlib.contextmanager
def counted_culls(monkeypatch):
    """``{"frustum": n, "beam": n}``: calls of the two cull wrappers."""
    calls = {"frustum": 0, "beam": 0}
    for kind in calls:
        real = getattr(sweep, f"{kind}_cull")

        def run(*args, _real=real, _kind=kind, **kw):
            calls[_kind] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(sweep, f"{kind}_cull", run)
    yield calls


@pytest.mark.parametrize("unit", ["frame", "progressive", "step"])
def test_a_unit_culls_once_of_each_kind(unit, monkeypatch):
    s = Small(faces=800, side=32)
    getattr(s, unit)()  # warm: the light's one copy
    sweep.reset_launch_counts()
    with counted_culls(monkeypatch) as calls:
        getattr(s, unit)()
    assert calls == {"frustum": 1, "beam": 1}
    assert not any(sweep.launch_counts.values())  # CPU: the plain chains


def test_cull_kernels_reject_cpu_tensors():
    d, eye, cmin, cmax = frustum_case("one_cluster")
    with pytest.raises(ValueError, match="CUDA"):
        sweep._frustum_cull_cuda(d, eye, cmin, cmax, TP, True)
    o, act, light, cmin, cmax = beam_case("one_cluster")
    with pytest.raises(ValueError, match="CUDA"):
        sweep._beam_cull_cuda(o, act, light, cmin, cmax, True)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

CONFIGS = ROOT / "portbench" / "configs"
TRAFFIC = ROOT / "portbench" / "traffic"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    from raytracercuda_torch.ops import cuda_build

    cuda_build.load_library()
    return torch.device("cuda", 0)


def config_scene(name: str, device):
    """A benchmark configuration file's scene built by the port: its
    meshes as the bumpy spheres they stand in for, its materials, seeded
    textures; ``(config, scene data, clusters)``."""
    config = json.loads((CONFIGS / f"{name}.json").read_text())
    scene = Scene(CONFIG, device=device)
    for m in config["meshes"]:
        mesh = bumpy_sphere_mesh(m["faces"], m["radius"], tuple(m["center"]),
                                 m["bump"], seed=m["mesh_seed"])
        mesh.material_id = m["material"]
        scene.add_mesh(mesh)
    scene.materials = [Material(albedo=x["albedo"], texture_id=x["texture"])
                       for x in config["materials"]]
    rng = np.random.default_rng(5)
    scene.textures = [rng.random((h, w, 3), dtype=np.float32)
                      for h, w in config["textures"]]
    return config, scene.data(), scene.accel


def orbit(traffic: str, center, radius: float, extent: float):
    """The poses ``(eye, orient)`` of a traffic file's orbit around
    ``center``: a pan step a frame, the pitch swinging once a period, the
    distance (in radii or box extents) between its two values."""
    t = json.loads((TRAFFIC / f"{traffic}.json").read_text())
    n, (lo, hi) = t["period"], t["distance"]
    unit = radius if t["distance_unit"] == "radius" else extent
    for k in range(n):
        phase = 2 * math.pi * k / n
        orient = orient_from_pan_pitch(
            math.radians(t["pan_deg_per_frame"] * k),
            math.radians(t["pitch_deg"]) * math.sin(phase))
        dist = unit * (lo + (hi - lo) * 0.5
                       * (1 - math.cos(t["distance_cycles"] * phase)))
        yield (np.asarray(center) - dist * orient[:, 2]).astype(np.float32), \
            orient


class AgainstChains:
    """Wraps the two CUDA cull wrappers: every call also runs the kernel on
    its input in the other layout, and the plain chain on both, on the
    card, and counts the mask entries that differ, their largest margin
    to the threshold, and the calls whose lists differ.  Within
    `chains()` the wrappers run the plain chains instead."""

    def __init__(self, monkeypatch):
        self.entries = self.differ = self.list_differ = self.calls = 0
        self.worst = 0.0
        self.plain = False
        for name, plain, margin in (
                ("_frustum_cull_cuda", sweep._frustum_cull_plain,
                 frustum_margin),
                ("_beam_cull_cuda", sweep._beam_cull_plain, beam_margin)):
            monkeypatch.setattr(sweep, name, self.wrap(
                getattr(sweep, name), plain, margin))

    def wrap(self, kernel, plain, margin):
        def run(x, *args):
            if self.plain:
                return plain(x, *args)
            got = kernel(x, *args)
            rest, planar = args[:-1], args[-1]
            for a in ((x, *rest, planar),
                      (x.transpose(1, 2).contiguous(), *rest, not planar)):
                self.tally(kernel(*a), plain(*a),
                           lambda t, c, a=a: margin(*a, t, c))
            return got
        return run

    def tally(self, got, want, margin):
        self.calls += 1
        self.entries += want.numel()
        bad = (got != want).nonzero()
        if len(bad):
            self.differ += len(bad)
            self.worst = max(self.worst,
                             float(margin(bad[:, 0], bad[:, 1]).max()))
        a, b = sweep._tile_lists(got), sweep._tile_lists(want)
        self.list_differ += not all(torch.equal(x, y) for x, y in zip(a, b))

    @contextlib.contextmanager
    def chains(self):
        self.plain = True
        try:
            yield
        finally:
            self.plain = False

    def report(self, what: str) -> str:
        return (f"{what}: {self.differ} differing mask entries of "
                f"{self.entries} over {self.calls} masks (both layouts), "
                f"largest relative margin {self.worst:.3g}; lists differ "
                f"in {self.list_differ}")


@pytest.mark.card
@pytest.mark.parametrize("traffic", ["near", "far"])
def test_frames_over_the_period_equal_the_chains(traffic, monkeypatch):
    """bunny69k.c512 (69,451 faces, 512x512, 1,024 tiles): every pose of
    the traffic's 240-frame orbit, rendered through the kernels and
    through the plain chains on the card, bit for bit; the masks compared
    at each call in both layouts."""
    dev = _card()
    config, data, accel = config_scene("bunny69k.c512", dev)
    side = config["width"]
    renderer = FrameRenderer(data, accel, CONFIG, config["height"], side)
    rays = camera_ray_grid(side, config["height"], device=dev)
    pos = data.positions.cpu().numpy()
    lo, hi = pos.min(0), pos.max(0)
    poses = list(orbit(traffic, (lo + hi) / 2, config["meshes"][0]["radius"],
                       float((hi - lo).max())))
    cmp = AgainstChains(monkeypatch)
    frames_differ = []
    for k, (eye, orient) in enumerate(poses):
        eye, orient = (torch.as_tensor(x, device=dev) for x in (eye, orient))
        got = renderer.render(eye, orient, rays)
        with cmp.chains():
            want = renderer.render(eye, orient, rays)
        if not torch.equal(got, want):
            frames_differ.append(k)
    print(cmp.report(f"{traffic}, {len(poses)} frames") +
          f"; frames not bit-equal: {frames_differ}")
    assert cmp.calls == 4 * len(poses)
    assert frames_differ == [] and cmp.worst <= CULL_THRESHOLD_REL


def armadillo_first_pass(dev):
    """armadillo346k-f16.c1024's first progressive pass from the
    configuration's view: ``(run, clusters)``, ``run()`` -> the image."""
    config, data, accel = config_scene("armadillo346k-f16.c1024", dev)
    w, h, v = config["width"], config["height"], config["view"]
    mesh = config["meshes"][v["mesh"]]
    orient = orient_from_pan_pitch(math.radians(v["pan_deg"]),
                                   math.radians(v["pitch_deg"]))
    eye = (np.asarray(mesh["center"]) - v["distance_radii"] * mesh["radius"]
           * orient[:, 2]).astype(np.float32)
    eye, orient = (torch.as_tensor(x, device=dev) for x in (eye, orient))

    def first_pass():
        with torch.no_grad():
            return progressive_step(init_progressive(w * h, device=dev),
                                    data, accel, eye, orient, w, h, CONFIG,
                                    with_shadows=True).image

    return first_pass, accel


@pytest.mark.card
def test_a_progressive_pass_equals_the_chains(monkeypatch):
    """armadillo346k-f16.c1024 (350,000 faces, 1024x1024, 4,096 tiles): a
    first pass from the configuration's view through the kernels and
    through the plain chains, bit for bit; the masks compared in both
    layouts."""
    dev = _card()
    first_pass, accel = armadillo_first_pass(dev)
    cmp = AgainstChains(monkeypatch)
    got = first_pass()
    with cmp.chains():
        want = first_pass()
    print(cmp.report("progressive, first pass") +
          f"; clusters {accel.num_clusters}")
    assert cmp.calls == 4
    assert torch.equal(got, want)
    assert cmp.worst <= CULL_THRESHOLD_REL


@pytest.fixture(scope="module")
def bench_sized():
    return Small(69451, 512, _card())


@pytest.mark.card
@pytest.mark.parametrize("unit", ["frame", "progressive", "step"])
def test_one_launch_per_cull_on_the_card(bench_sized, unit):
    run = getattr(bench_sized, unit)
    run()
    torch.cuda.synchronize()
    sweep.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    assert sweep.launch_counts["frustum_cull"] == 1
    assert sweep.launch_counts["beam_cull"] == 1


@pytest.mark.card
def test_a_frame_waits_only_for_the_lists(bench_sized):
    """Two synchronizing calls a frame, both the lists' `nonzero` (a pass
    and a step: `test_torch_tracing`)."""
    bench_sized.frame()
    torch.cuda.synchronize()
    assert _sync_sites(bench_sized.frame) == ["sync.tile_lists"] * 2


#: The sweeps that read staged rows: wrapper -> (rows, plain version).
STAGED_SWEEPS = {
    "_primary_shade_cuda": ("eye", sweep._primary_shade_plain),
    "_occlusion_cuda": ("light", sweep._occlusion_plain),
    "_primary_cuda": ("eye", sweep._primary_plain),
    "_occlusion_rows_cuda": ("light", sweep._occlusion_rows_plain),
}


def _same_bits(got, want) -> bool:
    return (bits_equal(got, want) if got.dtype == torch.float32
            else torch.equal(got, want))


def _staged_unit(unit: str, dev):
    """A unit whose sweeps read staged rows: the first frame of near's or
    far's period on bunny69k.c512 (A, B), armadillo346k-f16.c1024's first
    progressive pass (C, H), or a shadowed `render_rgb` of bunny69k.c512's
    first near pose without ``frame_hw`` (ray bundles: F's sweep, then H)."""
    if unit == "progressive":
        return armadillo_first_pass(dev)[0]
    config, data, accel = config_scene("bunny69k.c512", dev)
    pos = data.positions.cpu().numpy()
    lo, hi = pos.min(0), pos.max(0)
    eye, orient = next(orbit("near" if unit == "bundle" else unit,
                             (lo + hi) / 2, config["meshes"][0]["radius"],
                             float((hi - lo).max())))
    eye, orient = (torch.as_tensor(x, device=dev) for x in (eye, orient))
    if unit == "bundle":
        rays = camera_ray_grid(128, 128, device=dev)

        def bundle():
            with torch.no_grad():
                return render_grad.render_rgb(data, accel, rays, eye, orient,
                                              CONFIG, with_shadows=True)
        return bundle
    side = config["width"]
    renderer = FrameRenderer(data, accel, CONFIG, config["height"], side)
    rays = camera_ray_grid(side, config["height"], device=dev)
    return lambda: renderer.render(eye, orient, rays)


@pytest.mark.card
@pytest.mark.parametrize("unit", ["near", "far", "progressive", "bundle"])
def test_staged_sweeps_equal_plain(unit, monkeypatch):
    """Every launch of A, B, C or H in the unit, run again: its staged eye
    or light rows bit-equal to `_eye_rows_plain` / `_light_rows_plain`,
    and its outputs (t, slot, u, v and A's attributes; B's and H's mask)
    bit-equal to its plain version's on the same inputs.  The staged
    tables count A + C and B + H launches; F's sweep (the bundles' closest
    hit) stages none."""
    dev = _card()
    run = _staged_unit(unit, dev)
    run()  # warm-up: the light's first copy to the card
    torch.cuda.synchronize()
    calls = []
    for name in STAGED_SWEEPS:
        def spy(*args, _name=name, _real=getattr(sweep, name)):
            calls.append((_name, args))
            return _real(*args)
        monkeypatch.setattr(sweep, name, spy)
    sweep.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    launches = dict(sweep.launch_counts)
    monkeypatch.undo()
    staged_counts(launches, unit)
    want_kinds = {"near": {"_primary_shade_cuda", "_occlusion_cuda"},
                  "far": {"_primary_shade_cuda", "_occlusion_cuda"},
                  "progressive": {"_primary_cuda", "_occlusion_rows_cuda"},
                  "bundle": {"_occlusion_rows_cuda"}}[unit]
    assert {name for name, _ in calls} == want_kinds
    if unit == "bundle":
        assert launches["closest_rays"] > 0 and launches["eye_rows"] == 0
    for name, args in calls:
        kind, plain = STAGED_SWEEPS[name]
        got = staged_rows_check(sweep, kind, getattr(sweep, name), args,
                                f"{unit} {name}")
        want = plain(*args)
        torch.cuda.synchronize()
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert _same_bits(g, w), f"{name} output {i}: " \
                f"{int((g != w).sum())} entries differ"
    print(f"{unit}: {len(calls)} staged sweeps bit-equal to plain; "
          f"launches {launches}")
