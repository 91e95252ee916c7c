"""The port's silhouette boundary term (`raytracercuda_torch.diff.edge_grad`)
against the JAX package's (`raytracercuda_tpu.diff.edge_grad`) on the CPU:
the edge table, the sample placement with XLA's roundings, and
`boundary_vjp` on BRUTE (kernel E's plain version; JAX's XLA route) and
CLUSTER (C's epilogue over F's sweep, plain; JAX's
`dense.trace_clusters_rays`).  The scenes are `test_edge_grad.py`'s 9x9
flat triangle, a 300-face triangle soup (every edge a boundary edge) and a
closed 320-face bumpy sphere (interior edges, silhouettes where the two
faces turn apart).

The JAX package traces the probes along their camera-space directions;
the port turns them into the world by the orientation first
(`edge_grad._probe_world`), as the forward render turns its rays.  The
comparisons with JAX under a rotated view (`jax_probe_rule`) put JAX's
rule in that one place, so that every other rule is still held to
JAX's; `test_probes_leave_the_eye_toward_their_samples` holds the port's
own rule."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import (
    jax_config,
    jax_scene,
    numpy_scene,
    time_limit,
    torch_clusters,
    torch_config,
    torch_scene,
)

import jax
import jax.numpy as jnp

from raytracercuda_tpu.accel.clusters import build_clusters as jax_build
from raytracercuda_tpu.config import AccelKind as JaxAccelKind
from raytracercuda_tpu.config import RenderConfig as JaxRenderConfig
from raytracercuda_tpu.diff import edge_grad as jeg
from raytracercuda_tpu.models.procedural import bumpy_sphere_mesh
from raytracercuda_tpu.trace.pipeline import trace_hit as jax_trace_hit

from raytracercuda_torch.accel.clusters import build_clusters
from raytracercuda_torch.config import AccelKind, RenderConfig
from raytracercuda_torch.diff import edge_grad as teg
from raytracercuda_torch.models.camera import orient_from_pan_pitch
from raytracercuda_torch.trace.pipeline import trace_hit


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own limit: far above its time on one worker (< 15 s)."""
    with time_limit(120):
        yield


def flat_tri_fields() -> dict:
    """`test_edge_grad.flat_tri_scene` as numpy fields."""
    return dict(
        positions=np.array([[-2.0, -2.0, 3.0], [2.0, -2.0, 3.4],
                            [0.0, 2.5, 3.2]], np.float32),
        faces=np.array([[0, 1, 2, 0]], np.int32),
        attrs={1: np.array([[0.0, 0.0, -1.0]] * 3, np.float32)},
        mesh_material=np.zeros(1, np.int32),
        albedo=np.array([[0.8, 0.6, 0.4]], np.float32),
        texture_id=np.array([-1], np.int32),
        textures=np.zeros((1, 1, 1, 3), np.float32))


def sphere_fields(num_faces: int = 320, seed: int = 4) -> dict:
    """A closed bumpy sphere (shared vertices, interior edges) with random
    vertex normals, in front of an eye at the origin."""
    m = bumpy_sphere_mesh(num_faces, radius=1.0, center=(0.1, -0.1, 3.0),
                          bump=0.2, seed=seed)
    idx = np.asarray(m.indices, np.int32).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    nv = m.num_vertices
    return dict(
        positions=np.asarray(m.positions, np.float32),
        faces=np.concatenate([idx, np.zeros((len(idx), 1), np.int32)], 1),
        attrs={1: rng.standard_normal((nv, 3)).astype(np.float32)},
        mesh_material=np.zeros(1, np.int32),
        albedo=np.array([[0.8, 0.6, 0.4]], np.float32),
        texture_id=np.array([-1], np.int32),
        textures=np.zeros((1, 1, 1, 3), np.float32))


# name -> (fields, width, height, eye, (pan, pitch), zoom, samples)
SCENES = {
    "flat_tri": (flat_tri_fields, 9, 9, (0.0, 0.0, 0.0), (0.0, 0.0), 1.0, 4),
    "soup300": (lambda: numpy_scene(300, seed=5), 24, 20,
                (0.05, -0.02, 0.2), (0.04, -0.03), 1.0, 4),
    "sphere320": (sphere_fields, 21, 17, (0.02, 0.03, 0.0), (0.02, 0.05),
                  1.25, 3),
}
KINDS = ("brute", "cluster")


def case(name: str, kind: str):
    fields, width, height, eye, pan_pitch, zoom, samples = SCENES[name]
    f = fields()
    js, ts = jax_scene(f), torch_scene(f)
    if kind == "brute":
        jcfg = JaxRenderConfig(accel=JaxAccelKind.BRUTE)
        tcfg = RenderConfig(accel=AccelKind.BRUTE)
        jacc = tacc = None
    else:
        jcfg, tcfg = jax_config(), torch_config()
        jacc = jax_build(js.positions, js.faces, jcfg.cluster)
        tacc = torch_clusters(jacc)
    ev, ef = teg.build_edge_table(f["faces"])
    g = np.random.default_rng(3).uniform(
        -1.0, 1.0, (height * width, 3)).astype(np.float32)
    return dict(f=f, js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, jacc=jacc,
                tacc=tacc, ev=ev, ef=ef, g=g, width=width, height=height,
                eye=np.asarray(eye, np.float32),
                orient=orient_from_pan_pitch(*pan_pitch).astype(np.float32),
                zoom=zoom, samples=samples)


def port_args(c):
    return (torch.from_numpy(c["g"]), c["ts"], c["tacc"],
            torch.from_numpy(c["ev"]), torch.from_numpy(c["ef"]),
            torch.from_numpy(c["eye"]), torch.from_numpy(c["orient"]),
            c["tcfg"], c["width"], c["height"])


def jax_boundary(c):
    return [np.asarray(x) for x in jeg.boundary_vjp(
        jnp.asarray(c["g"]), c["js"], c["jacc"], jnp.asarray(c["ev"]),
        jnp.asarray(c["ef"]), jnp.asarray(c["eye"]),
        jnp.asarray(c["orient"]), c["jcfg"], c["width"], c["height"],
        zoom=c["zoom"], num_samples=c["samples"])]


@pytest.fixture
def jax_probe_rule(monkeypatch):
    """The port's probes traced along their camera-space directions, as
    the JAX package traces them (it never turns them by the orientation:
    `raytracercuda_tpu/diff/edge_grad.py:199-206`)."""
    monkeypatch.setattr(teg, "_probe_world", lambda dirs, orient: dirs)


def probes(c):
    """The live samples' probe directions (``[2N, 3]``) from the port."""
    s = teg.edge_samples(c["ts"].positions, c["ts"].faces,
                         torch.from_numpy(c["ev"]), torch.from_numpy(c["ef"]),
                         torch.from_numpy(c["eye"]),
                         torch.from_numpy(c["orient"]), c["width"],
                         c["height"], c["zoom"], c["samples"])
    rows = s.live.reshape(-1).nonzero()[:, 0]
    delta = 0.05 * min(2.0 / c["width"], 2.0 / c["height"])
    return teg.probe_dirs(s, rows, delta, c["zoom"]).reshape(-1, 3)


def assert_probe_faces_agree(c) -> int:
    """Both packages' traversals pick the same face for every probe ray:
    the bar of `test_torch_pipeline_bundles.py` (faces equal but for exact
    t ties within 1e-6 relative), and the seeds are chosen so that no tie
    occurs.  Returns the number of probes that hit."""
    d = probes(c)
    o = torch.from_numpy(c["eye"])[None, :].expand(d.shape)
    want = jax_trace_hit(c["js"], c["jacc"], jnp.asarray(o.numpy()),
                         jnp.asarray(d.numpy()), c["jcfg"])
    got = trace_hit(c["ts"], c["tacc"], o, d, c["tcfg"])
    wf, gf = np.asarray(want.face), got.face.numpy()
    wt, gt = np.asarray(want.t), got.t.numpy()
    tie = np.abs(gt - wt) <= 1e-6 * np.abs(wt)
    assert (tie | (wf == gf)).all(), f"{int((wf != gf).sum())} probes differ"
    np.testing.assert_array_equal(gf, wf)
    return int((gf >= 0).sum())


def test_edge_table_two_faces():
    """`test_edge_grad.py:56`: five edges, one shared, four boundary."""
    faces = np.array([[0, 1, 2, 0], [1, 3, 2, 0]], np.int32)
    ev, ef = teg.build_edge_table(faces)
    jev, jef = jeg.build_edge_table(faces)
    np.testing.assert_array_equal(ev, jev)
    np.testing.assert_array_equal(ef, jef)
    assert ev.dtype == np.int32 and ef.dtype == np.int32
    shared = [(tuple(v), tuple(f)) for v, f in zip(ev, ef) if f[1] >= 0]
    assert shared == [((1, 2), (0, 1))]
    assert sum(f[1] == -1 for f in ef) == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_table_matches_jax(seed):
    """Random index tables, with repeated and non-manifold edges (three
    faces on one edge keep their first two), and a torch tensor input."""
    rng = np.random.default_rng(seed)
    faces = rng.integers(0, 40, (120, 4)).astype(np.int32)
    faces[:, 3] = 0
    faces[5] = [7, 8, 9, 0]
    faces[6] = [8, 7, 10, 0]
    faces[7] = [7, 8, 11, 0]
    ev, ef = teg.build_edge_table(torch.from_numpy(faces))
    jev, jef = jeg.build_edge_table(faces)
    np.testing.assert_array_equal(ev, jev)
    np.testing.assert_array_equal(ef, jef)
    assert (ef[:, 1] >= 0).any() and (ef[:, 1] < 0).any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sample_placement_matches_xla(name):
    """The rules that pick a sample's pixel: XLA compiles ``/ dx`` as a
    product with float32 ``1 / dx`` and ``a + tau ev`` as a fused
    multiply-add.  The port's endpoints (`project_screen`) are held within
    1e-6 relative of JAX's; its sample points, pixels and in-frame flags,
    taken from JAX's endpoints, equal JAX's jitted lookup bit for bit."""
    c = case(name, "brute")
    W, H, K, zoom = c["width"], c["height"], c["samples"], c["zoom"]
    dx, dy = 2.0 / W, -2.0 / H

    @jax.jit
    def lookup(pos, ev, eye, orient):
        a, _ = jeg.project_screen(pos[ev[:, 0]], eye, orient, zoom)
        b, _ = jeg.project_screen(pos[ev[:, 1]], eye, orient, zoom)
        tau = (jnp.arange(K, dtype=jnp.float32) + 0.5) / K
        x = a[:, None, :] + tau[None, :, None] * (b - a)[:, None, :]
        px = jnp.floor((x[..., 0] + 1.0) / dx).astype(jnp.int32)
        py = jnp.floor((x[..., 1] - 1.0) / dy).astype(jnp.int32)
        in_frame = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        pix = jnp.clip(py, 0, H - 1) * W + jnp.clip(px, 0, W - 1)
        return a, b, x, pix, in_frame

    ja, jb, jx, jpix, jin = (np.asarray(v) for v in lookup(
        c["js"].positions, jnp.asarray(c["ev"]), jnp.asarray(c["eye"]),
        jnp.asarray(c["orient"])))
    ev = torch.from_numpy(c["ev"]).long()
    pos, eye = c["ts"].positions, torch.from_numpy(c["eye"])
    orient = torch.from_numpy(c["orient"])
    a, za = teg.project_screen(pos[ev[:, 0]], eye, orient, zoom)
    np.testing.assert_allclose(a.numpy(), ja, rtol=1e-6, atol=1e-7)
    # The placement from JAX's own endpoints, through the port's rules.
    ta, tb = torch.from_numpy(ja.copy()), torch.from_numpy(jb.copy())
    tau = (torch.arange(K, dtype=torch.float32) + 0.5) * teg._recip32(K)
    x = teg.fma32(tau[None, :, None], (tb - ta)[:, None, :], ta[:, None, :])
    np.testing.assert_array_equal(x.numpy(), jx)
    px = torch.floor((x[..., 0] + 1.0) * teg._recip32(dx)).to(torch.int32)
    py = torch.floor((x[..., 1] - 1.0) * teg._recip32(dy)).to(torch.int32)
    pix = py.clamp(0, H - 1).long() * W + px.clamp(0, W - 1)
    np.testing.assert_array_equal(pix.numpy(), jpix)
    np.testing.assert_array_equal(
        ((px >= 0) & (px < W) & (py >= 0) & (py < H)).numpy(), jin)
    # A true division would read other pixels' quotients: the rule matters.
    if name == "flat_tri":
        q = (x[..., 0] + 1.0) / np.float32(dx)
        assert (q != (x[..., 0] + 1.0) * teg._recip32(dx)).any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_boundary_vjp_matches_jax(name, kind, jax_probe_rule):
    """(d_positions, d_eye, d_orient) within rtol 1e-5, atol 1e-6 of JAX's
    jitted `boundary_vjp`, once every probe's face agrees; the probes
    traced by JAX's rule (`jax_probe_rule`)."""
    c = case(name, kind)
    hits = assert_probe_faces_agree(c)
    assert hits > 0
    want = jax_boundary(c)
    got = teg.boundary_vjp(*port_args(c), zoom=c["zoom"],
                           num_samples=c["samples"])
    assert (np.abs(want[0]) > 0).any(), "no live sample: weak fixture"
    for w, x, what in zip(want, got, ("positions", "eye", "orient")):
        assert x.shape == w.shape and x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), w, rtol=1e-5, atol=1e-6,
                                   err_msg=what)


@pytest.mark.parametrize("kind", KINDS)
def test_compacted_probes_equal_every_probe(kind):
    """Tracing only the live samples' probes gives the same bits as
    tracing every probe (JAX's route: the rest count an exact 0)."""
    c = case("sphere320", kind)
    got = teg.boundary_vjp(*port_args(c), zoom=c["zoom"],
                           num_samples=c["samples"])
    full = teg.boundary_vjp(*port_args(c), zoom=c["zoom"],
                            num_samples=c["samples"], compact=False)
    assert (got[0] != 0).any()
    for a, b in zip(got, full):
        assert torch.equal(a, b)


def test_no_live_sample_gives_zero():
    """An eye behind the triangle's plane looking away: nothing live,
    nothing traced, exact zeros."""
    c = case("flat_tri", "brute")
    args = list(port_args(c))
    args[6] = torch.from_numpy(orient_from_pan_pitch(np.pi, 0.0))
    d_pos, d_eye, d_orient = teg.boundary_vjp(*args)
    for x in (d_pos, d_eye, d_orient):
        assert torch.equal(x, torch.zeros_like(x))


#: Views turned away from the identity (pan, pitch).
TURNED_VIEWS = [(0.02, 0.05), (0.7, -0.3), (2.4, 0.4)]


def turned_scene(c, pan_pitch):
    """``c``'s scene moved in front of its eye turned by ``pan_pitch``:
    ``(scene, eye, orient)``."""
    orient = torch.from_numpy(orient_from_pan_pitch(*pan_pitch))
    eye = torch.from_numpy(c["eye"])
    # Put the mesh in front of the eye along the view direction.
    pos = c["ts"].positions
    shift = (eye + 3.0 * orient[:, 2]) - pos.mean(0)
    return c["ts"]._replace(positions=pos + shift), eye, orient


@pytest.mark.parametrize("pan_pitch", TURNED_VIEWS)
def test_probes_leave_the_eye_toward_their_samples(pan_pitch):
    """Each probe's world direction, projected back to the screen, lands
    ``delta`` inside or outside its sample along the outward normal
    (within 1e-5 of a pixel): the probes leave along the view's rays,
    whatever the orientation; under the identity the turn is exact."""
    c = case("sphere320", "brute")
    ts, eye, orient = turned_scene(c, pan_pitch)
    ev, ef = torch.from_numpy(c["ev"]), torch.from_numpy(c["ef"])
    W, H, zoom, K = c["width"], c["height"], c["zoom"], c["samples"]
    s = teg.edge_samples(ts.positions, ts.faces, ev, ef, eye, orient, W, H,
                         zoom, K)
    rows = s.live.reshape(-1).nonzero()[:, 0]
    assert rows.numel() > 20
    delta = 0.05 * min(2.0 / W, 2.0 / H)
    cam = teg.probe_dirs(s, rows, delta, zoom).reshape(-1, 3)
    world = teg._probe_world(cam, orient)
    back, _ = teg.project_screen(eye + world, eye, orient, zoom)
    x = s.x.reshape(-1, 2)[rows]
    n = s.nhat[rows // K]
    want = torch.cat([x - delta * n, x + delta * n])
    assert float((back - want).abs().max()) < 1e-5 * 2.0 / W
    assert torch.equal(teg._probe_world(cam, torch.eye(3)), cam)


def edge_order(rows, pix, width, height):
    """`edge_grad._screen_order` replaced by the identity: the probes in
    the edge table's order."""
    return rows


# The turned sphere at 64x48 with 16 samples an edge: its live probes
# fill several 256-ray groups of the trace.
ORDER_W, ORDER_H, ORDER_K = 64, 48, 16


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("pan_pitch", TURNED_VIEWS)
@pytest.mark.parametrize("kind", KINDS)
def test_screen_order_gives_the_edge_orders_bits(kind, pan_pitch, compact,
                                                 monkeypatch):
    """`boundary_vjp`'s (d_positions, d_eye, d_orient) with the probes in
    screen order equal, bit for bit, those in the edge table's order, on
    the compacted and the full route: a probe's closest hit does not
    depend on the rays that share its group (CLUSTER: 16-face clusters,
    so that the groups' lists differ), and every later step reads a
    sample by its own row."""
    c = case("sphere320", "brute")
    ts, eye, orient = turned_scene(c, pan_pitch)
    if kind == "brute":
        tcfg, tacc = RenderConfig(accel=AccelKind.BRUTE), None
    else:
        tcfg = RenderConfig(accel=AccelKind.CLUSTER)
        tcfg = dataclasses.replace(tcfg, cluster=dataclasses.replace(
            tcfg.cluster, cluster_size=16))
        tacc = build_clusters(ts.positions, ts.faces, tcfg.cluster)
    ev, ef = torch.from_numpy(c["ev"]), torch.from_numpy(c["ef"])
    g = torch.from_numpy(np.random.default_rng(7).uniform(
        -1.0, 1.0, (ORDER_W * ORDER_H, 3)).astype(np.float32))
    args = (g, ts, tacc, ev, ef, eye, orient, tcfg, ORDER_W, ORDER_H)
    # The fixture is not trivial: several groups, reordered.
    s = teg.edge_samples(ts.positions, ts.faces, ev, ef, eye, orient,
                         ORDER_W, ORDER_H, 1.0, ORDER_K)
    rows = (s.live.reshape(-1).nonzero()[:, 0] if compact
            else torch.arange(s.live.numel()))
    assert 2 * rows.numel() > 3 * 256
    assert not torch.equal(
        teg._screen_order(rows, s.pix.reshape(-1), ORDER_W, ORDER_H), rows)
    got = teg.boundary_vjp(*args, num_samples=ORDER_K, compact=compact)
    monkeypatch.setattr(teg, "_screen_order", edge_order)
    want = teg.boundary_vjp(*args, num_samples=ORDER_K, compact=compact)
    assert (want[0] != 0).any()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def morton_codes(px: np.ndarray, py: np.ndarray, bits: int) -> np.ndarray:
    """Z-order codes bit by bit: bit i of x at 2i, of y at 2i + 1."""
    key = np.zeros(px.shape, np.int64)
    for i in range(bits):
        key |= ((px >> i) & 1) << (2 * i)
        key |= ((py >> i) & 1) << (2 * i + 1)
    return key


@pytest.mark.parametrize("size", [(64, 48), (33, 1025)])
@pytest.mark.parametrize("pan_pitch", TURNED_VIEWS)
def test_screen_order_sorts_the_live_rows_by_morton_code(pan_pitch, size):
    """`_screen_order` on the live rows of the turned sphere: a
    permutation of them, their pixels' Morton codes (``ceil(log2(max(W,
    H)))`` bits an axis) ascending, and rows of one code in the edge
    table's order."""
    width, height = size
    c = case("sphere320", "brute")
    ts, eye, orient = turned_scene(c, pan_pitch)
    s = teg.edge_samples(ts.positions, ts.faces, torch.from_numpy(c["ev"]),
                         torch.from_numpy(c["ef"]), eye, orient, width,
                         height, 1.0, ORDER_K)
    pix = s.pix.reshape(-1)
    rows = s.live.reshape(-1).nonzero()[:, 0]
    got = teg._screen_order(rows, pix, width, height)
    assert got.dtype == rows.dtype
    assert torch.equal(torch.sort(got).values, rows)
    p = pix[got].numpy()
    bits = int(np.ceil(np.log2(max(width, height))))
    key = morton_codes(p % width, p // width, bits)
    assert (np.diff(key) >= 0).all()
    tie = np.diff(key) == 0
    assert tie.any(), "no two live samples share a pixel: weak fixture"
    assert (np.diff(got.numpy())[tie] > 0).all()
