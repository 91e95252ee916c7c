"""`render_rgb_silhouette` of the port against the JAX package's on the
CPU, and the finite-difference checks of `test_edge_grad.py` and
`test_diff.py` (vertex, camera and silhouette) on the port alone: BRUTE
through kernel E's plain version, CLUSTER through C's (frames) and C's
epilogue over F's sweep (the probes)."""

import numpy as np
import pytest
import torch

from torch_parity import time_limit
from test_torch_edge_grad import (SCENES, case, assert_probe_faces_agree,
                                  jax_probe_rule)

import jax
import jax.numpy as jnp

from raytracercuda_tpu.config import DiffConfig as JaxDiffConfig
from raytracercuda_tpu.diff import render_grad as jrg

from raytracercuda_torch import interop
from raytracercuda_torch.config import AccelKind, DiffConfig, RenderConfig
from raytracercuda_torch.diff import render_grad as trg
from raytracercuda_torch.models.camera import camera_ray_grid


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own limit: far above its time on one worker (< 20 s)."""
    with time_limit(150):
        yield


def with_diff(c, **kw):
    """The case's configs with ``DiffConfig(**kw)`` on both sides."""
    import dataclasses

    c = dict(c)
    c["jcfg"] = dataclasses.replace(c["jcfg"], diff=JaxDiffConfig(**kw))
    c["tcfg"] = dataclasses.replace(c["tcfg"], diff=DiffConfig(**kw))
    return c


def weights(c):
    n = c["width"] * c["height"]
    return np.random.default_rng(8).uniform(0.2, 1.0, (n, 3)).astype(
        np.float32)


def port_grads(c, w):
    """Gradients of ``sum(img * w)`` for positions, normals, albedo, eye and
    orient, and the image."""
    ts = c["ts"]
    leaves = [x.clone().requires_grad_() for x in (
        ts.positions, ts.attrs[1], ts.albedo, torch.from_numpy(c["eye"]),
        torch.from_numpy(c["orient"]))]
    p, n, a, e, o = leaves
    sc = ts._replace(positions=p, attrs={**ts.attrs, 1: n}, albedo=a)
    img = trg.render_rgb_silhouette(sc, c["tacc"], e, o, c["tcfg"],
                                    c["width"], c["height"], zoom=c["zoom"])
    (img * torch.from_numpy(w)).sum().backward()
    return [x.grad.numpy() for x in leaves], img.detach()


def jax_grads(c, w):
    js = c["js"]

    def loss(p, n, a, e, o):
        sc = js._replace(positions=p, attrs={**js.attrs, 1: n}, albedo=a)
        img = jrg.render_rgb_silhouette(sc, c["jacc"], e, o, c["jcfg"],
                                        c["width"], c["height"],
                                        zoom=c["zoom"])
        return jnp.sum(img * jnp.asarray(w))

    args = (js.positions, js.attrs[1], js.albedo, jnp.asarray(c["eye"]),
            jnp.asarray(c["orient"]))
    return [np.asarray(g) for g in jax.grad(loss, argnums=range(5))(*args)]


NAMES = ("positions", "normals", "albedo", "eye", "orient")
CASES = [(name, kind) for name in sorted(SCENES)
         for kind in ("brute", "cluster")]


@pytest.mark.parametrize("name,kind", CASES)
def test_forward_equals_render_rgb(name, kind):
    """The silhouette render changes only the backward pass: its image is
    `render_rgb`'s with ``frame_hw``, bit for bit (CLUSTER frames of 9x9,
    24x20 and 21x17 are edge-padded to whole tiles)."""
    c = case(name, kind)
    eye, orient = torch.from_numpy(c["eye"]), torch.from_numpy(c["orient"])
    got = trg.render_rgb_silhouette(c["ts"], c["tacc"], eye, orient,
                                    c["tcfg"], c["width"], c["height"],
                                    zoom=c["zoom"])
    rays = camera_ray_grid(c["width"], c["height"], zoom=c["zoom"],
                           device="cpu")
    want = trg.render_rgb(c["ts"], c["tacc"], rays, eye, orient, c["tcfg"],
                          frame_hw=(c["height"], c["width"]))
    assert got.shape == (c["width"] * c["height"], 3)
    assert torch.equal(got, want)
    assert (want[:, 1] != 1.0).any()  # something was hit


@pytest.mark.parametrize("kind", ["brute", "cluster"])
def test_flag_off_reduces_to_interior(kind):
    """`test_edge_grad.py:109-134`: with ``silhouette=False`` the gradients
    are `render_rgb`'s (autograd through the fixed-id render) bit for bit,
    and with it on the boundary term changes them."""
    c = with_diff(case("sphere320", kind), silhouette=False)
    w = weights(c)
    off, _ = port_grads(c, w)

    ts = c["ts"]
    leaves = [x.clone().requires_grad_() for x in (
        ts.positions, ts.attrs[1], ts.albedo, torch.from_numpy(c["eye"]),
        torch.from_numpy(c["orient"]))]
    p, n, a, e, o = leaves
    rays = camera_ray_grid(c["width"], c["height"], zoom=c["zoom"],
                           device="cpu")
    img = trg.render_rgb(ts._replace(positions=p, attrs={**ts.attrs, 1: n},
                                     albedo=a), c["tacc"], rays, e, o,
                         c["tcfg"], frame_hw=(c["height"], c["width"]))
    (img * torch.from_numpy(w)).sum().backward()
    for name, g, x in zip(NAMES, off, leaves):
        np.testing.assert_array_equal(g, x.grad.numpy(), err_msg=name)

    on, _ = port_grads(with_diff(c, silhouette=True), w)
    assert not np.allclose(on[0], off[0])
    assert not np.allclose(on[3], off[3])
    # The boundary term touches neither the normals nor the albedo.
    np.testing.assert_array_equal(on[1], off[1])
    np.testing.assert_array_equal(on[2], off[2])


@pytest.mark.parametrize("name,kind", CASES)
def test_gradients_match_jax(name, kind, jax_probe_rule):
    """Positions, normals, albedo, eye and orient against JAX's `jax.grad`,
    once every probe's face agrees
    (`test_torch_edge_grad.assert_probe_faces_agree`), the port's probes
    traced along their camera-space directions as JAX traces them
    (`test_torch_edge_grad.jax_probe_rule`).  The interior part
    (``silhouette=False``) at `test_torch_diff.py`'s bar, rtol 1e-4 and
    atol 1e-4 of max|g|: XLA on the CPU contracts the recompute's
    multiply-adds, and the soup's nearly edge-on triangles amplify the
    last bits.  The boundary term, the gradients with ``silhouette=True``
    less those without, within rtol 1e-5 and atol 1e-5 of its largest
    entry (at least 1e-6), plus the float32 rounding of the sum it was
    added to (2^-23 of each side's entry): each sample's coefficient is a
    difference of two radiances, and where the two probes see nearly equal
    shading it keeps only the leading digits of the shading's last-bit
    differences (measured on the soup: 1.2e-4 of a coefficient, 3.4e-5 of
    one gradient entry, 1.8e-6 of the largest)."""
    c = case(name, kind)
    assert_probe_faces_agree(c)
    w = weights(c)
    got = {on: port_grads(with_diff(c, silhouette=on), w)[0]
           for on in (False, True)}
    want = {on: jax_grads(with_diff(c, silhouette=on), w)
            for on in (False, True)}
    for i, label in enumerate(NAMES):
        g, x = got[False][i], want[False][i]
        assert g.shape == x.shape and np.isfinite(got[True][i]).all(), label
        np.testing.assert_allclose(g, x, rtol=1e-4,
                                   atol=1e-4 * np.abs(x).max(),
                                   err_msg=f"interior {label}")
        b_got, b_want = got[True][i] - g, want[True][i] - x
        bar = (max(1e-6, 1e-5 * float(np.abs(b_want).max()))
               + 1e-5 * np.abs(b_want)
               + 2.0 ** -23 * (np.abs(got[True][i]) + np.abs(want[True][i])))
        assert (np.abs(b_got - b_want) <= bar).all(), (
            f"boundary {label}: max excess "
            f"{float((np.abs(b_got - b_want) - bar).max())}")
    boundary = want[True][0] - want[False][0]
    assert np.abs(boundary).max() > 0, "no boundary term: weak fixture"


# ---------------------------------------------------------------------------
# Finite differences on the port alone.
# ---------------------------------------------------------------------------

W = H = 9
BRUTE = RenderConfig(accel=AccelKind.BRUTE)
EYE = torch.zeros(3)
ORIENT = torch.eye(3)


def tri_scene(normals=None):
    """`test_diff.tilted_tri_scene` (varying vertex normals) or, with
    ``normals``, the same triangle flat-shaded."""
    if normals is None:
        normals = np.array([[0.3, 0.1, -0.95], [-0.2, 0.25, -0.94],
                            [0.05, -0.3, -0.95]], np.float32)
    return interop.scene_from_numpy(
        positions=np.array([[-2.0, -2.0, 3.0], [2.0, -2.0, 3.4],
                            [0.0, 2.5, 3.2]], np.float32),
        faces=np.array([[0, 1, 2, 0]], np.int32), attrs={1: normals},
        mesh_material=np.zeros(1, np.int32),
        albedo=np.array([[0.8, 0.6, 0.4]], np.float32),
        texture_id=np.array([-1], np.int32),
        textures=np.zeros((1, 1, 1, 3), np.float32), device="cpu")


FLAT = np.array([[0.0, 0.0, -1.0]] * 3, np.float32)


def box_filtered(scene, config, ss):
    """The ``ss``-times supersampled image, box-filtered to 9x9."""
    rays = camera_ray_grid(W * ss, H * ss, device="cpu")
    with torch.no_grad():
        img = trg.render_rgb(scene, None, rays, EYE, ORIENT, config)
    return img.numpy().reshape(H, ss, W, ss, 3).mean(axis=(1, 3)).reshape(
        -1, 3)


@pytest.mark.parametrize("axis", [0, 1])
def test_silhouette_gradient_matches_fd(axis):
    """`test_edge_grad.py:66-106`: a translation of a flat-shaded triangle
    has only a boundary gradient; its Simpson average over [-eps, eps]
    matches central differences of the 64x box-filtered image of a linear
    loss within rtol 0.12."""
    scene = tri_scene(FLAT)
    config = RenderConfig(accel=AccelKind.BRUTE, diff=DiffConfig(
        silhouette=True, edge_samples=2048, edge_offset_px=0.02))
    w = torch.from_numpy(np.random.default_rng(0).uniform(
        0.2, 1.0, (H * W, 3)).astype(np.float32))
    step = torch.zeros(3)
    step[axis] = 1.0

    def grad(dx: float) -> float:
        d = torch.tensor(dx, requires_grad=True)
        sc = scene._replace(positions=scene.positions + step * d)
        img = trg.render_rgb_silhouette(sc, None, EYE, ORIENT, config, W, H)
        (img * w).sum().backward()
        return float(d.grad)

    eps = 0.1
    analytic0 = grad(0.0)
    simpson = (grad(-eps) + 4.0 * analytic0 + grad(eps)) / 6.0
    fd_imgs = [box_filtered(scene._replace(
        positions=scene.positions + step * s), config, 64)
        for s in (eps, -eps)]
    fd = float(np.sum((fd_imgs[0] - fd_imgs[1]) * w.numpy()) / (2 * eps))
    assert abs(fd) > 0.05, f"fixture too weak: fd={fd}"
    assert analytic0 != 0.0
    assert np.isclose(simpson, fd, rtol=0.12), (simpson, fd)


RAYS = camera_ray_grid(W, H, device="cpu")
_mask = np.zeros((H, W), np.float32)
_mask[3:6, 3:6] = 1.0
MASK = torch.from_numpy(_mask.reshape(-1, 1))


def masked_loss(scene, eye=EYE, orient=ORIENT):
    """`test_diff.masked_loss`: the centre 3x3 pixels, far from the
    silhouette."""
    img = trg.render_rgb(scene, None, RAYS, eye, orient, BRUTE)
    return torch.sum((img * MASK) ** 2)


def test_vertex_gradient_matches_fd():
    """`test_diff.py:79`: each vertex's x and z gradient of the interior
    loss against central differences (eps 1e-3, rtol 0.05, atol 1e-4)."""
    scene = tri_scene()
    p = scene.positions.clone().requires_grad_()
    masked_loss(scene._replace(positions=p)).backward()
    g = p.grad.numpy()
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
    eps = 1e-3
    with torch.no_grad():
        for vi in range(3):
            for ci in (2, 0):
                q = scene.positions.clone()
                q[vi, ci] += eps
                lp = float(masked_loss(scene._replace(positions=q)))
                q[vi, ci] -= 2 * eps
                lm = float(masked_loss(scene._replace(positions=q)))
                fd = (lp - lm) / (2 * eps)
                assert np.isclose(g[vi, ci], fd, rtol=0.05, atol=1e-4), (
                    vi, ci, g[vi, ci], fd)


def test_camera_gradient_matches_fd():
    """`test_diff.py:113`: the eye's gradient against central differences
    (rtol 0.05, atol 1e-5), and not vanishing.  The step is 1e-2, not
    1e-3: the loss is ~2.45 in float32 (ulp 2.4e-7), so at 1e-3 the
    difference quotient moves in steps of 1.2e-4, 5% of the z gradient
    (-0.002457 on both packages; their quotients read -0.002265 here and
    -0.002384 in JAX)."""
    scene = tri_scene()
    e = EYE.clone().requires_grad_()
    masked_loss(scene, eye=e).backward()
    g = e.grad.numpy()
    eps = 1e-2
    with torch.no_grad():
        for ci in range(3):
            d = torch.zeros(3)
            d[ci] = eps
            fd = (float(masked_loss(scene, eye=d))
                  - float(masked_loss(scene, eye=-d))) / (2 * eps)
            assert np.isclose(g[ci], fd, rtol=0.05, atol=1e-5), (ci, g[ci],
                                                                fd)
    assert (np.abs(g) > 1e-6).any(), "camera gradient vanished"


def test_silhouette_gradients_disagree_with_fd():
    """`test_diff.py:252`: without the boundary term, `render_rgb`'s
    gradient of a flat triangle's translation misses the coverage jump
    that finite differences see."""
    scene = tri_scene(FLAT)
    step = torch.tensor([1.0, 0.0, 0.0])

    def full_loss(dx):
        sc = scene._replace(positions=scene.positions + step * dx)
        return torch.sum(trg.render_rgb(sc, None, RAYS, EYE, ORIENT,
                                        BRUTE) ** 2)

    def coverage(dx):
        with torch.no_grad():
            img = trg.render_rgb(scene._replace(
                positions=scene.positions + step * dx), None, RAYS, EYE,
                ORIENT, BRUTE)
        return int((img[:, 1] < 0.5).sum())

    eps = next((c for c in (0.05, 0.1, 0.2, 0.35, 0.5)
                if coverage(c) != coverage(-c)), None)
    assert eps is not None, "no coverage flip found; fixture broken"
    with torch.no_grad():
        fd = (float(full_loss(eps)) - float(full_loss(-eps))) / (2 * eps)
    d = torch.tensor(0.0, requires_grad=True)
    full_loss(d).backward()
    analytic = float(d.grad)
    assert abs(fd) > 1.0, f"fixture too weak: fd={fd}"
    assert abs(analytic) < 0.05 * abs(fd), (analytic, fd)
