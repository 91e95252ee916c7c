"""The silhouette step's tracing and its host constants
(`raytracercuda_torch/diff/edge_grad.py`, `render_grad.render_rgb_silhouette`):
the step is bit-equal with program tracing on and off, and with the
probes in screen order or in the edge table's order; it records
``grad.boundary`` under ``grad`` with its four children and counts the
live samples and the clusters the probes' groups listed
(``general_pairs``, fewer in screen order on a triangle soup); and once
the first step has filled the caches, a step copies nothing from the
host: not the edge table held on the device, not the probe offset, the
light or the background.  The probe offset is held bit for bit against
the copy it replaced.

A copy from the host is seen here as a call, from the program's code, of
a tensor factory on host data with a ``device`` (`torch.tensor`,
`torch.as_tensor`, `torch.asarray`) or of a tensor's ``to`` with one: on
a card each is a blocking host-to-device copy; on the CPU the same call
is made, so the CPU sees it."""

from __future__ import annotations

import collections
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracercuda_torch import interop
from raytracercuda_torch.accel.clusters import build_clusters
from raytracercuda_torch.config import AccelKind, RenderConfig
from raytracercuda_torch.diff import edge_grad, render_grad
from raytracercuda_torch.models.camera import orient_from_pan_pitch
from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
from raytracercuda_torch.models.scene import Material, Scene
from raytracercuda_torch.ops.math import fma32
from raytracercuda_torch.trace import bounce_sweep
from raytracercuda_torch.utils import profiler
from torch_parity import time_limit as _time_limit

CONFIG = RenderConfig(accel=AccelKind.CLUSTER)
LIGHT = (0.4, 0.8, -0.45)
SIDE = 32
PROGRAM = str(Path(edge_grad.__file__).resolve().parents[1])
BOUNDARY_CHILDREN = ["boundary.samples", "sync.live_samples",
                     "boundary.probes", "boundary.project"]


@pytest.fixture(autouse=True)
def time_limit():
    with _time_limit(120.0):
        profiler.collect()
        yield
        assert not profiler.enabled
        profiler.collect()


class Fit:
    """A textured bumpy sphere seen from a turned camera, its edge table
    on the device, and a target: one silhouette step's inputs."""

    config = CONFIG

    def __init__(self):
        scene = Scene(CONFIG, device="cpu")
        self.orient = torch.as_tensor(orient_from_pan_pitch(0.6, -0.2),
                                      dtype=torch.float32)
        self.eye = torch.tensor([0.2, -0.1, 0.3])
        centre = (self.eye + 3.0 * self.orient[:, 2]).tolist()
        mesh = bumpy_sphere_mesh(900, 1.0, tuple(centre), seed=4)
        mesh.material_id = 0
        scene.add_mesh(mesh)
        scene.materials = [Material(albedo=(0.8, 0.7, 0.6), texture_id=0)]
        scene.textures = [np.random.default_rng(1).random(
            (8, 8, 3), dtype=np.float32)]
        self.data = scene.data()
        self.host_table = edge_grad.build_edge_table(self.data.faces)
        self.table = tuple(torch.as_tensor(t) for t in self.host_table)
        self.target = torch.rand(SIDE * SIDE, 3,
                                 generator=torch.Generator().manual_seed(2))

    def step(self, table=None):
        """Rebuild, render with the boundary term, the loss, backward():
        -> (image, loss, position gradient)."""
        p = self.data.positions.clone().requires_grad_()
        accel = build_clusters(p.detach(), self.data.faces,
                               self.config.cluster)
        img = render_grad.render_rgb_silhouette(
            self.data._replace(positions=p), accel, self.eye, self.orient,
            self.config, SIDE, SIDE, light_dir=LIGHT,
            edge_table=self.table if table is None else table)
        loss = torch.mean((img - self.target) ** 2)
        loss.backward()
        return img.detach(), loss.detach(), p.grad

    def samples(self):
        return edge_grad.edge_samples(
            self.data.positions, self.data.faces, *self.table, self.eye,
            self.orient, SIDE, SIDE, 1.0, CONFIG.diff.edge_samples)


class Soup(Fit):
    """600 small triangles scattered in front of a turned camera, in
    16-face clusters: a group of probes in the edge table's order holds
    samples from all over the frame and its cone lists every cluster,
    one in screen order lists those along a patch of the frame."""

    config = dataclasses.replace(CONFIG, cluster=dataclasses.replace(
        CONFIG.cluster, cluster_size=16))

    def __init__(self):
        rng = np.random.default_rng(5)
        n = 600
        self.orient = torch.as_tensor(orient_from_pan_pitch(0.3, 0.1),
                                      dtype=torch.float32)
        self.eye = torch.tensor([0.1, 0.2, -0.3])
        centres = np.stack([rng.uniform(-1.2, 1.2, n),
                            rng.uniform(-1.2, 1.2, n),
                            rng.uniform(2.0, 4.0, n)], axis=1)
        cam = centres[:, None, :] + rng.uniform(-0.08, 0.08, (n, 3, 3))
        world = (cam.reshape(-1, 3).astype(np.float32)
                 @ self.orient.numpy().T + self.eye.numpy())
        faces = np.concatenate([np.arange(3 * n).reshape(n, 3),
                                np.zeros((n, 1))], axis=1).astype(np.int32)
        self.data = interop.scene_from_numpy(
            positions=world.astype(np.float32), faces=faces,
            attrs={1: rng.standard_normal((3 * n, 3)).astype(np.float32)},
            mesh_material=np.zeros(1, np.int32),
            albedo=np.array([[0.8, 0.6, 0.4]], np.float32),
            texture_id=np.array([-1], np.int32),
            textures=np.zeros((1, 1, 1, 3), np.float32), device="cpu")
        self.host_table = edge_grad.build_edge_table(self.data.faces)
        self.table = tuple(torch.as_tensor(t) for t in self.host_table)
        self.target = torch.rand(SIDE * SIDE, 3,
                                 generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def fit():
    return Fit()


def edge_order(rows, pix, width, height):
    """`edge_grad._screen_order` replaced by the identity: the probes in
    the edge table's order."""
    return rows


def traced_step(fit, monkeypatch, order=None):
    """``fit.step()`` with program tracing on, the probes in ``order``
    (screen order when None): -> (the step's outputs, its counters)."""
    with monkeypatch.context() as m:
        if order is not None:
            m.setattr(edge_grad, "_screen_order", order)
        with profiler.tracing():
            out = fit.step()
    return out, profiler.collect().counters


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


class HostCopies:
    """Records the program's calls that copy host data to a device, by
    their call site (file, function), while the block runs: the tensor
    factories and `torch.Tensor.to` are wrapped for the block on every
    thread (the backward of a render runs in autograd's engine)."""

    FACTORIES = ("tensor", "as_tensor", "asarray")

    def __init__(self):
        self.sites = []
        self.saved = []

    def _record(self):
        caller = sys._getframe(2).f_code
        if caller.co_filename.startswith(PROGRAM):
            self.sites.append((Path(caller.co_filename).name,
                               caller.co_name))

    def _wrap(self, owner, name, copies):
        inner = getattr(owner, name)

        def wrapped(*args, **kw):
            if copies(args, kw):
                self._record()
            return inner(*args, **kw)

        self.saved.append((owner, name, inner))
        setattr(owner, name, wrapped)

    def __enter__(self):
        for name in self.FACTORIES:
            self._wrap(torch, name, lambda args, kw: (
                kw.get("device") is not None
                and not isinstance(args[0], torch.Tensor)))
        self._wrap(torch.Tensor, "to", lambda args, kw: (
            "device" in kw or any(isinstance(a, (torch.device, str))
                                  for a in args[1:])))
        return self

    def __exit__(self, *exc):
        while self.saved:
            setattr(*self.saved.pop())
        return None


def test_the_step_is_bit_equal_with_tracing_on_and_off(fit, monkeypatch):
    """Also with the probes in the edge table's order: the order moves
    no bit of the step."""
    off = fit.step()
    on, _ = traced_step(fit, monkeypatch)
    edge, _ = traced_step(fit, monkeypatch, edge_order)
    assert (off[2] != 0).any()
    for a, b, c in zip(off, on, edge):
        assert same_bits(a, b) and same_bits(a, c)


def test_the_step_records_the_boundary_spans(fit):
    with profiler.tracing():
        fit.step()
    spans = profiler.collect().spans
    by_id = {s.id: s for s in spans}
    (boundary,) = [s for s in spans if s.name == "grad.boundary"]
    assert by_id[boundary.parent].name == "grad"
    assert by_id[boundary.parent].parent is None
    children = sorted((s for s in spans if s.parent == boundary.id),
                      key=lambda s: s.start_ns)
    assert [s.name for s in children] == BOUNDARY_CHILDREN
    for s in children:
        assert boundary.start_ns <= s.start_ns <= s.end_ns \
            <= boundary.end_ns
        assert s.unit == boundary.unit == boundary.parent


def test_the_counters_read_the_live_samples_and_probes(fit, monkeypatch):
    live = int(fit.samples().live.sum())
    assert live > 0
    fit.step()  # the light and background reach their caches
    listed, probes = [], []
    sweep = bounce_sweep._closest_rays_plain

    def closest_rays(lists, o3, d3, active, *args):
        listed.append(lists.ids.numel())
        probes.append(int(active.sum()))
        return sweep(lists, o3, d3, active, *args)

    monkeypatch.setattr(bounce_sweep, "_closest_rays_plain", closest_rays)
    with profiler.tracing():
        fit.step()
    rec = profiler.collect()
    assert rec.counters["boundary_live_samples"] == live
    # Two probe rays a live sample.
    assert probes == [2 * rec.counters["boundary_live_samples"]]
    # Only the probes trace a bundle: the pairs their groups listed.
    assert len(listed) == 1 and listed[0] > 0
    assert rec.counters["general_pairs"] == listed[0]
    # Each wait is a sync.* span and a count: the live samples' one too.
    waits = [s.name for s in rec.spans if s.name.startswith("sync.")]
    assert waits.count("sync.live_samples") == 1
    assert rec.counters["host_syncs"] == len(waits) == 3


def test_screen_order_lists_fewer_clusters_on_a_soup(monkeypatch):
    """On a scattered scene the probes' groups in screen order list
    fewer clusters than in the edge table's order (the general cull's
    cones narrow), with the same live samples, host waits and bits."""
    soup = Soup()
    screen, on = traced_step(soup, monkeypatch)
    edge, off = traced_step(soup, monkeypatch, edge_order)
    probes = 2 * on["boundary_live_samples"]
    groups = -(-probes // 256)
    assert groups > 8 and probes == 2 * off["boundary_live_samples"]
    assert on["host_syncs"] == off["host_syncs"]
    assert on["general_pairs"] < 0.9 * off["general_pairs"]
    assert (screen[2] != 0).any()
    for a, b in zip(screen, edge):
        assert same_bits(a, b)


def test_after_the_first_step_nothing_is_copied_from_the_host(fit,
                                                              monkeypatch):
    monkeypatch.setattr(render_grad, "_LIGHTS", {})
    seen = []
    vjp = edge_grad.boundary_vjp

    def boundary_vjp(*args, **kw):
        seen.append(args[3:5])
        return vjp(*args, **kw)

    monkeypatch.setattr(edge_grad, "boundary_vjp", boundary_vjp)
    first, again = HostCopies(), HostCopies()
    with first:
        want = fit.step()
    with again:
        got = fit.step()
    assert again.sites == []
    # The first step copies each constant once: the light, the background.
    assert collections.Counter(first.sites) == {
        ("render_grad.py", "_light_on"): 2}
    for a, b in zip(want, got):
        assert same_bits(a, b)
    # The device's table reaches the term itself, no copy of it.
    assert all(v is fit.table[0] and f is fit.table[1] for v, f in seen)
    cached = {tuple(l.tolist()): l for l in render_grad._LIGHTS.values()}
    assert set(cached) == {tuple(np.float32(LIGHT).tolist()),
                           (0.0, 1.0, 0.0)}
    assert all(l._version == 0 for l in cached.values())
    # A host table, by contrast, is copied on every step.
    host = HostCopies()
    with host:
        fit.step(fit.host_table)
    assert host.sites == [("render_grad.py", "<genexpr>")] * 2


def probe_dirs_with_tensor_delta(s, rows, delta, zoom):
    """`edge_grad.probe_dirs` as it was, with the offset copied to the
    rays' device as a float32 tensor."""
    x = s.x.reshape(-1, 2)[rows]
    nhat = s.nhat[rows // s.tau.numel()]
    d = torch.tensor(delta, dtype=torch.float32, device=x.device)
    pr = torch.stack([fma32(-d, nhat, x), fma32(d, nhat, x)])
    z = torch.full(pr.shape[:-1] + (1,), float(zoom), dtype=torch.float32)
    p = torch.cat([pr, z], dim=-1)
    return p / torch.sqrt(edge_grad.dot_fused(p, p))[..., None]


@pytest.mark.parametrize("offset_px", [0.05, 0.01, 1.0 / 3.0, 0.7071067811])
def test_the_probe_offset_is_bit_equal_to_the_copied_one(fit, offset_px):
    s = fit.samples()
    rows = s.live.reshape(-1).nonzero()[:, 0]
    for side, zoom in ((SIDE, 1.0), (1024, 1.25)):
        delta = offset_px * 2.0 / side
        assert same_bits(edge_grad.probe_dirs(s, rows, delta, zoom),
                         probe_dirs_with_tensor_delta(s, rows, delta, zoom))
