"""The port's differentiable render (`raytracercuda_torch.diff.render_grad`)
against the JAX package's on the CPU: images, gradients with respect to
every continuous input, the custom-VJP form, and the repairs of the
gradient route (the zero-determinant guard, the up-front `frame_hw`
check).  JAX runs kernels C and H in Pallas interpret mode
(`use_pallas_sweep=True`), and kernel G too when `_FORCE_TILED` is set;
the port runs their plain versions."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import (
    jax_config,
    jax_scene,
    numpy_scene,
    torch_clusters,
    torch_config,
    torch_scene,
)

import jax
import jax.numpy as jnp

import raytracercuda_tpu.diff.render_grad as jrg
from raytracercuda_tpu.accel.clusters import build_clusters as jax_build
from raytracercuda_tpu.config import AccelKind as jax_accel_kind
from raytracercuda_tpu.models.camera import camera_ray_grid

import raytracercuda_torch.diff.render_grad as trg
from raytracercuda_torch.config import AccelKind as TorchAccelKind
from raytracercuda_torch.config import RenderConfig as TorchRenderConfig
from raytracercuda_torch.diff import scatter as tscatter
from raytracercuda_torch.models.camera import orient_from_pan_pitch

EYE = (0.05, -0.02, 1.0)  # inside the frame of the test cloud, close up


def setup(side=32, num_faces=1200, seed=17, textured=False):
    f = numpy_scene(num_faces, seed=seed, textured=textured)
    js, ts = jax_scene(f), torch_scene(f)
    jcfg = jax_config()
    jc = jax_build(js.positions, js.faces, jcfg.cluster)
    rays = np.array(camera_ray_grid(side, side))
    orient = orient_from_pan_pitch(0.04, -0.03)
    return dict(js=js, ts=ts, jc=jc, tc=torch_clusters(jc), jcfg=jcfg,
                tcfg=torch_config(), rays=rays, side=side,
                eye=np.asarray(EYE, np.float32), orient=orient)


def jax_args(s):
    return (jnp.asarray(s["rays"]), jnp.asarray(s["eye"]),
            jnp.asarray(s["orient"]))


def torch_args(s):
    return (torch.from_numpy(s["rays"]), torch.from_numpy(s["eye"]),
            torch.from_numpy(s["orient"]))


def assert_ids_agree(s):
    """Both traversals pick the same face for every pixel (seeds are
    chosen so; a near-tie would make the gradients incomparable)."""
    side = s["side"]
    jr, je, jo = jax_args(s)
    jd = jr @ jo.T
    want = np.array(jrg.hit_ids_nondiff(
        s["js"], s["jc"], jnp.broadcast_to(je, jd.shape), jd, s["jcfg"],
        frame_hw=(side, side), common_origin=je))
    tr, te, to = torch_args(s)
    td = trg.rotate_rays(tr, to)
    got = trg.hit_ids_nondiff(s["ts"], s["tc"], te.expand(td.shape), td,
                              s["tcfg"], frame_hw=(side, side),
                              common_origin=te)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    hit = want >= 0
    assert 0.1 < hit.mean() < 0.95
    return want


# (textured, shadows, shading, seed)
RENDER_CASES = {
    "lambert": (False, False, "lambert", 17),
    "shadows": (False, True, "lambert", 17),
    "textured": (True, False, "lambert", 19),
    "textured_shadows": (True, True, "lambert", 19),
    "normal": (False, False, "normal", 23),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_rgb_matches_jax(case):
    textured, shadows, shading, seed = RENDER_CASES[case]
    s = setup(seed=seed, textured=textured)
    side = s["side"]
    assert_ids_agree(s)
    kw = dict(shading=shading, with_shadows=shadows, frame_hw=(side, side))
    want = np.asarray(jrg.render_rgb(s["js"], s["jc"], *jax_args(s),
                                     s["jcfg"], **kw))
    got = trg.render_rgb(s["ts"], s["tc"], *torch_args(s), s["tcfg"], **kw)
    assert got.shape == (side * side, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if shadows:  # the shadow test changed some pixels
        lit = trg.render_rgb(s["ts"], s["tc"], *torch_args(s), s["tcfg"],
                             shading=shading, frame_hw=(side, side))
        assert ((lit - got).abs().amax(dim=1) > 1e-3).sum() > 10


def test_fixed_ids_part_matches_jax():
    """`_render_fixed_ids` on ids and a shadow mask given to both sides:
    the traversal's ids with a fifth of them turned into misses, and a
    random mask."""
    s = setup(seed=19, textured=True)
    side = s["side"]
    rng = np.random.default_rng(0)
    n = side * side
    ids = assert_ids_agree(s)
    ids[rng.random(n) < 0.2] = -1
    mask = rng.random(n) < 0.3
    want = np.asarray(jrg._render_fixed_ids(
        s["js"], *jax_args(s), jnp.asarray(ids), jnp.asarray(mask),
        s["jcfg"], "lambert", (0.4, 0.8, -0.45), accel=s["jc"],
        frame_hw=(side, side)))
    got = trg._render_fixed_ids(
        s["ts"], *torch_args(s), torch.from_numpy(ids),
        torch.from_numpy(mask), s["tcfg"], "lambert", (0.4, 0.8, -0.45),
        accel=s["tc"], frame_hw=(side, side))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_generic_lambert_matches_jax():
    """The generic shading route (`recompute_hit`, then
    `shade_lambert_rgb`: interpolated normals, textured material albedo)
    on the traversal's ids and a shadow mask given to both sides."""
    from raytracercuda_tpu.trace.shade import shade_lambert_rgb as jshade

    from raytracercuda_torch.trace.shade import shade_lambert_rgb

    s = setup(seed=19, textured=True)
    ids = assert_ids_agree(s)
    mask = np.random.default_rng(1).random(ids.shape) < 0.3
    jr, je, jo = jax_args(s)
    jd = jr @ jo.T
    jo_ = jnp.broadcast_to(je, jd.shape)
    want = np.asarray(jshade(s["js"], jrg.recompute_hit(
        s["js"], jnp.asarray(ids), jo_, jd), jo_, jd,
        shadow_mask=jnp.asarray(mask)))
    tr, te, to = torch_args(s)
    td = trg.rotate_rays(tr, to)
    to_ = te.expand(td.shape)
    got = shade_lambert_rgb(s["ts"], trg.recompute_hit(
        s["ts"], torch.from_numpy(ids), to_, td), to_, td,
        shadow_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (want[ids >= 0, 1] != 1.0).any()  # shaded hits, not background


GRAD_NAMES = ("positions", "normals", "albedo", "textures", "eye", "orient")


def jax_grads(s, shadows):
    side = s["side"]
    target = jnp.full((side * side, 3), 0.25, jnp.float32)
    rays = jnp.asarray(s["rays"])

    def loss(p, n, a, t, e, o):
        sc = s["js"]._replace(positions=p, attrs={**s["js"].attrs, 1: n},
                              albedo=a, textures=t)
        return jrg.l2_image_loss(sc, s["jc"], rays, e, o, target, s["jcfg"],
                                 with_shadows=shadows, frame_hw=(side, side))

    js = s["js"]
    args = (js.positions, js.attrs[1], js.albedo, js.textures,
            jnp.asarray(s["eye"]), jnp.asarray(s["orient"]))
    return [np.asarray(g) for g in jax.grad(loss, argnums=range(6))(*args)]


def torch_leaves(s):
    ts = s["ts"]
    return [x.clone().requires_grad_() for x in (
        ts.positions, ts.attrs[1], ts.albedo, ts.textures,
        torch.from_numpy(s["eye"]), torch.from_numpy(s["orient"]))]


def torch_loss(s, leaves, shadows, render=None):
    side = s["side"]
    p, n, a, t, e, o = leaves
    sc = s["ts"]._replace(positions=p, attrs={**s["ts"].attrs, 1: n},
                          albedo=a, textures=t)
    target = torch.full((side * side, 3), 0.25)
    img = (render or trg.render_rgb)(
        sc, s["tc"], torch.from_numpy(s["rays"]), e, o, s["tcfg"],
        with_shadows=shadows, frame_hw=(side, side))
    return torch.mean((img - target) ** 2)


def torch_grads(s, shadows, render=None):
    leaves = torch_leaves(s)
    torch_loss(s, leaves, shadows, render).backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("tiled", [False, True])
def test_gradients_match_jax(tiled, monkeypatch):
    s = setup(seed=19, textured=True)
    assert_ids_agree(s)
    if tiled:
        # JAX takes its slot-ordered route (kernel G in interpret mode)
        # only when forced off the TPU; the port takes it whenever the
        # clusters carry face_rank and 256 divides the ray count.
        monkeypatch.setattr(jrg, "_FORCE_TILED", True)
        jax.clear_caches()
    else:
        s["tc"] = s["tc"]._replace(face_rank=None)
    before = tscatter.launch_counts["scatter_add"]
    want = jax_grads(s, shadows=True)
    got = torch_grads(s, shadows=True)
    assert tscatter.launch_counts["scatter_add"] == before  # CPU: plain
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all() and np.abs(w).max() > 0, name
        # XLA on the CPU contracts multiply-adds, so the recomputed t, u,
        # v and everything shaded from them differ from the port's
        # separately rounded operations in the last bits, and nearly
        # edge-on triangles of the test cloud amplify that.  Measured
        # worst: 4.6e-5 of max|g|, on small entries, while a float64 run
        # of the port puts both sides 4e-4 of max|g| from the exact
        # gradient; so the absolute bar is 1e-4 of max|g|.
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_render_vjp_matches_autograd():
    s = setup(seed=19, textured=True)
    want = torch_grads(s, shadows=True)
    got = torch_grads(s, shadows=True, render=trg.render_rgb_vjp)
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    side = s["side"]
    img = trg.render_rgb_vjp(s["ts"], s["tc"], *torch_args(s), s["tcfg"],
                             with_shadows=True, frame_hw=(side, side))
    ref = trg.render_rgb(s["ts"], s["tc"], *torch_args(s), s["tcfg"],
                         with_shadows=True, frame_hw=(side, side))
    np.testing.assert_array_equal(img.numpy(), ref.numpy())


def nan_trap_scene():
    """The test cloud plus a tiny flat triangle in the plane y = -5 at the
    scene's low corner: face 0, and (Morton code 0) slot 0, so every
    missing ray gathers its row.  Rays with a zero y component run
    parallel to its plane: their determinant against it is exactly 0."""
    f = numpy_scene(1200, seed=17)
    flat = np.array([[-5.0, -5.0, -5.0], [-4.999, -5.0, -5.0],
                     [-5.0, -5.0, -4.999]], np.float32)
    nv = flat.shape[0]
    f["positions"] = np.concatenate([flat, f["positions"]])
    faces = f["faces"].copy()
    faces[:, :3] += nv
    f["faces"] = np.concatenate([np.array([[0, 1, 2, 0]], np.int32), faces])
    rng = np.random.default_rng(3)
    f["attrs"][1] = np.concatenate(
        [rng.standard_normal((nv, 3)).astype(np.float32), f["attrs"][1]])
    return f


@pytest.mark.parametrize("tiled", [False, True])
def test_zero_det_gradients_finite(tiled):
    """A ray lying in a triangle's plane: the guarded denominator keeps
    every gradient of `l2_image_loss` finite."""
    from raytracercuda_torch.accel.clusters import build_clusters
    from raytracercuda_torch.models.camera import camera_ray_grid as rays_fn

    side = 32
    ts = torch_scene(nan_trap_scene())
    cfg = torch_config()
    cs = build_clusters(ts.positions, ts.faces, cfg.cluster)
    assert int(cs.face_order[0]) == 0  # the flat triangle is slot 0
    if not tiled:
        cs = cs._replace(face_rank=None)
    rays = rays_fn(side, side, device="cpu").clone()
    rays[: 4 * side, 1] = 0.0  # four rows of rays parallel to y = -5
    eye = torch.tensor(EYE[:1] + (0.0,) + EYE[2:])  # eye in the plane y=0
    ids = trg.hit_ids_nondiff(ts, cs, eye.expand(rays.shape), rays, cfg,
                              frame_hw=(side, side), common_origin=eye)
    missed_flat = (ids[: 4 * side] < 0).sum()
    assert missed_flat > 0 and (ids >= 0).any()
    # The trap is armed: row 0's det is exactly 0 for those rays, and an
    # unguarded 1/det turns their masked zero cotangent into NaN.
    v = ts.positions[:3].clone().requires_grad_()
    d = rays[: 4 * side][ids[: 4 * side] < 0]
    e1, e2 = v[1] - v[0], v[2] - v[0]
    det = (e1 * torch.cross(d, e2.expand(d.shape), dim=1)).sum(1)
    assert (det == 0).all()
    torch.where(torch.ones_like(det, dtype=torch.bool), 0.0,
                1.0 / det).sum().backward()
    assert torch.isnan(v.grad).any()

    p = ts.positions.clone().requires_grad_()
    loss = trg.l2_image_loss(ts._replace(positions=p), cs, rays, eye,
                             torch.eye(3), torch.zeros(side * side, 3), cfg,
                             frame_hw=(side, side))
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(p.grad).all()
    assert (p.grad[3:] != 0).any()


def test_frame_hw_mismatch_raises():
    s = setup()
    with pytest.raises(ValueError, match=r"frame_hw \(32, 16\).*1024 rays"):
        trg.render_rgb(s["ts"], s["tc"], *torch_args(s), s["tcfg"],
                       frame_hw=(32, 16))
    rows = torch.zeros(10, 4)
    with pytest.raises(ValueError, match=r"frame_hw \(16, 32\).*256 rays"):
        tscatter.gather_rows_tiled(rows, torch.zeros(256, dtype=torch.int32),
                                   (1, 256), frame_hw=(16, 32))


def test_unported_routes_raise():
    """`render_rgb` on BVH with shadows, with ``frame_hw`` (kernel L's plain
    version) and without (kernel K's), equals JAX's: the BVH routes that
    raised until the LBVH was ported.  Shadows on GRID raise, in the JAX
    package (its any-hit walk gets a hash grid) and in the port, which
    keeps that fault."""
    from raytracercuda_tpu.accel.grid import build_grid as jax_grid
    from raytracercuda_tpu.accel.bvh import build_bvh as jax_bvh
    from raytracercuda_tpu.config import RenderConfig as JaxRenderConfig

    from raytracercuda_torch.accel.bvh import build_bvh
    from raytracercuda_torch.accel.grid import build_grid

    s = setup()
    side = s["side"]
    jcfg = JaxRenderConfig(accel=jax_accel_kind.BVH)
    tcfg = TorchRenderConfig(accel=TorchAccelKind.BVH)
    jb = jax_bvh(s["js"].positions, s["js"].faces, jcfg.bvh)
    tb = build_bvh(s["ts"].positions, s["ts"].faces, tcfg.bvh)
    for frame_hw in ((side, side), None):
        kw = dict(with_shadows=True, frame_hw=frame_hw)
        want = np.asarray(jrg.render_rgb(s["js"], jb, *jax_args(s), jcfg,
                                         **kw))
        got = trg.render_rgb(s["ts"], tb, *torch_args(s), tcfg, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        assert (np.abs(want - want[0]).max(axis=1) > 0.1).mean() > 0.1
    tcfg = TorchRenderConfig(accel=TorchAccelKind.GRID)
    jcfg = JaxRenderConfig(accel=jax_accel_kind.GRID)
    with pytest.raises(NotImplementedError,
                       match="render_grad.py:408-416"):
        trg.render_rgb(s["ts"], build_grid(s["ts"].positions, s["ts"].faces,
                                           tcfg.grid),
                       *torch_args(s), tcfg, with_shadows=True,
                       frame_hw=(side, side))
    with pytest.raises(AttributeError, match="packed_tris"):
        jrg.render_rgb(s["js"], jax_grid(s["js"].positions, s["js"].faces,
                                         jcfg.grid),
                       *jax_args(s), jcfg, with_shadows=True,
                       frame_hw=(side, side))


@pytest.mark.parametrize("shadows", [False, True])
def test_brute_render_matches_jax(shadows):
    """BRUTE traces and tests shadows through kernel E's plain version;
    JAX through its oracle.  Same bar as the CLUSTER cases."""
    s = setup(seed=17)
    side = s["side"]
    kw = dict(with_shadows=shadows, frame_hw=(side, side))
    want = np.asarray(jrg.render_rgb(
        s["js"], None, *jax_args(s),
        dataclasses.replace(s["jcfg"], accel=jax_accel_kind.BRUTE), **kw))
    got = trg.render_rgb(s["ts"], None, *torch_args(s),
                         TorchRenderConfig(accel=TorchAccelKind.BRUTE), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    cluster = trg.render_rgb(s["ts"], s["tc"], *torch_args(s), s["tcfg"],
                             **kw)
    np.testing.assert_allclose(got.numpy(), cluster.numpy(), rtol=0,
                               atol=1e-5)


def test_shadows_on_a_frame_the_tile_does_not_divide():
    """A 24x40 CLUSTER frame: the port edge-pads to 32x48 for kernels C
    and H and crops; JAX traces it per ray in XLA.  Pixels agree except
    near-ties of the two rules (at most 1%), within the CLUSTER cases'
    bar elsewhere."""
    s = setup()
    h, w = 24, 40
    rays = np.array(camera_ray_grid(w, h))
    kw = dict(with_shadows=True, frame_hw=(h, w))
    want = np.asarray(jrg.render_rgb(s["js"], s["jc"], jnp.asarray(rays),
                                     *jax_args(s)[1:], s["jcfg"], **kw))
    got = trg.render_rgb(s["ts"], s["tc"], torch.from_numpy(rays),
                         *torch_args(s)[1:], s["tcfg"], **kw).numpy()
    close = np.isclose(got, want, rtol=0, atol=1e-5).all(axis=1)
    print(f"24x40: {close.mean():.4f} of pixels within 1e-5")
    assert close.mean() >= 0.99
    lit = trg.render_rgb(s["ts"], s["tc"], torch.from_numpy(rays),
                         *torch_args(s)[1:], s["tcfg"], frame_hw=(h, w))
    assert ((lit.numpy() - got).max(axis=1) > 1e-3).sum() > 5
