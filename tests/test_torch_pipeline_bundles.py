"""CLUSTER ray bundles that are not a pinhole frame, against the JAX
package on the CPU: `trace_hit` (JAX: `dense.trace_clusters_rays`; the
port: groups of rays through the general cull and the plain version of
C's epilogue over F's sweep) and `render_rgb` without ``frame_hw`` (JAX's
shadows: `dense.any_hit_clusters_rays`; the port's: kernel H's plain
version over the same groups)."""

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

import jax.numpy as jnp

import raytracercuda_tpu.diff.render_grad as jrg
from raytracercuda_tpu.accel.clusters import build_clusters as jax_build
from raytracercuda_tpu.models.camera import camera_ray_grid
from raytracercuda_tpu.trace.pipeline import trace_hit as jax_trace_hit

import raytracercuda_torch.diff.render_grad as trg
from raytracercuda_torch.trace import bounce_sweep, sweep
from raytracercuda_torch.trace.pipeline import trace_hit
from raytracercuda_torch.types import FLT_MAX

NUM_RAYS = 3000


def setup(seed=17, num_faces=1200):
    f = numpy_scene(num_faces, seed=seed)
    js, ts = jax_scene(f), torch_scene(f)
    jc = jax_build(js.positions, js.faces, jax_config().cluster)
    return dict(f=f, js=js, ts=ts, jc=jc, tc=torch_clusters(jc))


def scattered_rays(positions, n=NUM_RAYS, seed=0):
    """``n`` rays from points on a sphere around the scene's box toward
    points inside it, with directions of random length (0.5 to 2): no
    geometry lies behind an origin, and consecutive rays share nothing."""
    rng = np.random.default_rng(seed)
    lo, hi = positions.min(axis=0), positions.max(axis=0)
    centre, radius = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    around = rng.normal(size=(n, 3))
    origins = centre + radius * around / np.linalg.norm(around, axis=1,
                                                        keepdims=True)
    aim = lo + rng.random((n, 3)) * (hi - lo)
    d = aim - origins
    d *= rng.uniform(0.5, 2.0, (n, 1)) / np.linalg.norm(d, axis=1,
                                                         keepdims=True)
    return origins.astype(np.float32), d.astype(np.float32)


def configs(clip):
    jcfg = jax_config()
    jcfg = dataclasses.replace(jcfg, trace=dataclasses.replace(
        jcfg.trace, clip_backward_hits=clip))
    tcfg = torch_config()
    tcfg = dataclasses.replace(tcfg, trace=dataclasses.replace(
        tcfg.trace, clip_backward_hits=clip))
    return jcfg, tcfg


@pytest.mark.parametrize("clip", [True, False])
def test_trace_hit_bundle_matches_jax(clip):
    """Faces equal on every ray but exact ties (the two t within 1e-6
    relative of JAX's); t, u and v within 1e-5 relative and 5e-5 absolute
    on hits (XLA on the CPU contracts multiply-adds, and JAX re-derives
    t, u and v with `tri_intersect`'s term order)."""
    s = setup()
    o, d = scattered_rays(s["f"]["positions"])
    jcfg, tcfg = configs(clip)
    want = jax_trace_hit(s["js"], s["jc"], jnp.asarray(o), jnp.asarray(d),
                         jcfg)
    got = trace_hit(s["ts"], s["tc"], torch.from_numpy(o),
                    torch.from_numpy(d), tcfg)
    wf, gf = np.asarray(want.face), got.face.numpy()
    wt, gt = np.asarray(want.t), got.t.numpy()
    assert got.face.dtype == torch.int32 and gf.shape == (NUM_RAYS,)
    hit = wf >= 0
    assert 0.1 < hit.mean() < 0.9
    differ = wf != gf
    tie = np.abs(gt - wt) <= 1e-6 * np.abs(wt)
    assert (tie | ~differ).all(), f"{int((differ & ~tie).sum())} rays differ"
    same = hit & ~differ
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   np.asarray(getattr(want, name))[same],
                                   rtol=1e-5, atol=5e-5, err_msg=name)
    assert (gt[~hit] == FLT_MAX).all() and (gf[~hit] == -1).all()


def test_bundle_groups_keep_ray_order():
    """`group_rays` keeps the given order and pads the last group; the
    bundle route returns one result per ray, as ray by ray."""
    x = torch.arange(10.0)[:, None].expand(10, 3)
    g = bounce_sweep.group_rays(x, 4)
    assert g.shape == (3, 4, 3)
    assert torch.equal(g.reshape(-1, 3)[:10], x)
    assert (g.reshape(-1, 3)[10:] == 0).all()
    mask = bounce_sweep.group_rays(torch.ones(10, dtype=torch.bool), 4)
    assert mask.dtype == torch.bool and int(mask.sum()) == 10

    s = setup(seed=3, num_faces=600)
    o, d = scattered_rays(s["f"]["positions"], n=300, seed=1)
    tcfg = torch_config().trace
    blocks = sweep.segment_blocks(s["tc"])
    whole = bounce_sweep.trace_rays(s["tc"], blocks, torch.from_numpy(o),
                                    torch.from_numpy(d), trace_cfg=tcfg)
    perm = np.random.default_rng(2).permutation(300)
    shuffled = bounce_sweep.trace_rays(
        s["tc"], blocks, torch.from_numpy(o[perm]), torch.from_numpy(d[perm]),
        rays_per_group=64, trace_cfg=tcfg)
    assert torch.equal(shuffled.face, whole.face[perm])
    assert torch.equal(shuffled.t, whole.t[perm])


@pytest.mark.parametrize("shadows", [False, True])
def test_render_rgb_without_frame_matches_jax(shadows):
    """`render_rgb` on CLUSTER without ``frame_hw``: the rays trace as a
    bundle on both sides, and the shadows too.  Same bar as the frame
    cases (`test_torch_diff.py`)."""
    f = numpy_scene(1200, seed=17)
    js, ts = jax_scene(f), torch_scene(f)
    jcfg = jax_config()
    jc = jax_build(js.positions, js.faces, jcfg.cluster)
    tc = torch_clusters(jc)
    rays = np.array(camera_ray_grid(24, 20))  # 480 rays: no whole group
    eye = np.asarray((0.05, -0.02, 1.0), np.float32)
    orient = np.eye(3, dtype=np.float32)
    want = np.asarray(jrg.render_rgb(js, jc, jnp.asarray(rays),
                                     jnp.asarray(eye), jnp.asarray(orient),
                                     jcfg, with_shadows=shadows))
    got = trg.render_rgb(ts, tc, torch.from_numpy(rays),
                         torch.from_numpy(eye), torch.from_numpy(orient),
                         torch_config(), with_shadows=shadows)
    assert got.shape == (480, 3)
    hit = (np.abs(want - np.array([0.0, 1.0, 0.0])) > 0).any(axis=1)
    assert 0.1 < hit.mean() < 0.95
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if shadows:  # the shadow test changed some pixels
        lit = trg.render_rgb(ts, tc, torch.from_numpy(rays),
                             torch.from_numpy(eye), torch.from_numpy(orient),
                             torch_config())
        assert ((lit - got).abs().amax(dim=1) > 1e-3).sum() > 5
