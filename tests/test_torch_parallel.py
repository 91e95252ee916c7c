"""The port's ray sharding (`raytracercuda_torch.parallel.{mesh,shard}`):
two ranks over gloo on the CPU (`torch_dist_workers.launch`) against the
unsharded calls, bit for bit, and the two-rank training step against the
JAX package's `make_train_step` on a two-device CPU mesh (the 8-device
CPU platform of `tests/conftest.py`)."""

import numpy as np
import pytest
import torch

from torch_parity import time_limit
from torch_dist_workers import (
    launch,
    reflective_scene,
    scene_16tris,
    sharded_renders,
    train_steps,
)

import jax.numpy as jnp

from raytracercuda_tpu.config import AccelKind as JaxAccelKind
from raytracercuda_tpu.config import RenderConfig as JaxRenderConfig
from raytracercuda_tpu.models.scene import SceneData as JaxSceneData
from raytracercuda_tpu.parallel import mesh as jmesh
from raytracercuda_tpu.parallel import shard as jshard

from raytracercuda_torch import interop
from raytracercuda_torch.accel.bvh import build_bvh
from raytracercuda_torch.accel.clusters import build_clusters
from raytracercuda_torch.config import AccelKind, RenderConfig
from raytracercuda_torch.diff.render_grad import render_rgb
from raytracercuda_torch.models.camera import camera_ray_grid
from raytracercuda_torch.parallel import mesh as tmesh
from raytracercuda_torch.trace.bounce import render_bounces
from raytracercuda_torch.trace.pipeline import rotate_rays
from raytracercuda_torch.trace.progressive import (
    init_progressive,
    progressive_step,
)


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own limit: far above its time on one worker (< 25 s);
    `launch` also stops its ranks after 120 s."""
    with time_limit(180):
        yield


class Band:
    """A stand-in mesh of ``size`` ranks seen from ``rank``, for the helpers
    that read only the mesh's size and rank."""

    def __init__(self, size, rank=0):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def get_local_rank(self):
        return self._rank


def test_pad_rays_for_mesh():
    rays = torch.ones((13, 3))
    padded, n = tmesh.pad_rays_for_mesh(rays, Band(8))
    assert padded.shape == (16, 3) and n == 13
    assert torch.equal(padded[13:], torch.zeros((3, 3)))
    same, n = tmesh.pad_rays_for_mesh(torch.ones((16, 3)), Band(8))
    assert same.shape == (16, 3) and n == 16


def test_ray_sharding_takes_contiguous_bands():
    x = torch.arange(12)
    bands = [tmesh.ray_sharding(Band(3, r), x) for r in range(3)]
    assert [b.tolist() for b in bands] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                           [8, 9, 10, 11]]
    assert tmesh.replicated(Band(3, 1), x) is x
    with pytest.raises(ValueError, match="pad_rays_for_mesh"):
        tmesh.ray_sharding(Band(5), x)


def test_initialize_distributed_noop_when_unconfigured(monkeypatch):
    for name in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_raises_when_launch_fails(monkeypatch):
    """A configured launch that cannot come up raises; it never falls back
    to one process."""
    with pytest.raises((ValueError, RuntimeError)):
        tmesh.initialize_distributed(init_method="nowhere://x",
                                     world_size=2, rank=0)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(KeyError):  # torchrun's WORLD_SIZE is missing
        tmesh.initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_two_rank_renders_equal_unsharded(tmp_path):
    """`render_sharded` (CLUSTER pixel bands with shadows, CLUSTER and BVH
    bundles), `render_bounces_sharded` and `progressive_step_sharded` on two
    ranks equal the unsharded calls bit for bit, on both ranks."""
    ranks = launch(sharded_renders, 2, tmp_path)
    eye, orient = torch.zeros(3), torch.eye(3)
    cluster = RenderConfig(accel=AccelKind.CLUSTER)
    bvh = RenderConfig(accel=AccelKind.BVH)
    scene = interop.scene_from_numpy(**scene_16tris(5), device="cpu")
    cs = build_clusters(scene.positions, scene.faces, cluster.cluster)
    tree = build_bvh(scene.positions, scene.faces, bvh.bvh)
    h, w = 64, 32
    rays = camera_ray_grid(w, h, device="cpu")
    with torch.no_grad():
        want = {
            "frame": render_rgb(scene, cs, rays, eye, orient, cluster,
                                with_shadows=True, frame_hw=(h, w)),
            "bundle": render_rgb(scene, cs, rays, eye, orient, cluster),
            "bvh": render_rgb(scene, tree, rays, eye, orient, bvh),
        }
    refl = interop.scene_from_numpy(**reflective_scene(), device="cpu")
    rcs = build_clusters(refl.positions, refl.faces, cluster.cluster)
    want["bounces"] = render_bounces(rcs, refl, eye, rotate_rays(rays, orient),
                                     h, w, cluster, num_bounces=2)
    st = init_progressive(h * w, device="cpu")
    for _ in range(2):
        st = progressive_step(st, scene, cs, eye, orient, w, h, cluster)
    for r, got in enumerate(ranks):
        for name, x in want.items():
            assert torch.equal(got[name], x), (r, name)
        assert torch.equal(got["progressive"].accum, st.accum)
        assert got["progressive"].count == 2
    hit = (want["frame"] - want["frame"][0]).abs().amax(dim=1) > 0
    assert hit.any() and (~hit).any()
    assert ((want["bounces"] - want["frame"]).abs() > 1e-3).any()


def jax_train(config_kind: str, steps: int):
    """The JAX package's `make_train_step` (`optax.adam(1e-2)`) on a
    two-device mesh, the same scene, rays and target."""
    f = scene_16tris(0)
    js = JaxSceneData(**{k: ({s: jnp.asarray(a) for s, a in v.items()}
                             if isinstance(v, dict) else jnp.asarray(v))
                         for k, v in f.items()})
    config = JaxRenderConfig(accel=JaxAccelKind[config_kind])
    accel = None
    if config.accel == JaxAccelKind.BVH:
        from raytracercuda_tpu.accel.bvh import build_bvh as jax_bvh

        accel = jax_bvh(js.positions, js.faces, config.bvh)
    from raytracercuda_tpu.models.camera import camera_ray_grid as jrays

    rays = jrays(32, 32)
    target = jnp.zeros((rays.shape[0], 3))
    mesh = jmesh.make_ray_mesh(2)
    step, optimizer = jshard.make_train_step(config, mesh)
    params = {"positions": js.positions}
    opt_state = optimizer.init(params)
    history = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, js, accel, rays,
                                       jnp.zeros(3), jnp.eye(3), target)
        history.append((np.asarray(params["positions"]), float(loss)))
    return history


@pytest.mark.parametrize("config_kind", ["BRUTE", "BVH"])
def test_two_rank_train_step_matches_jax(tmp_path, config_kind):
    """Three Adam steps (lr 1e-2) of the all-reduced two-rank step: both
    ranks hold the same params bit for bit, and after each step the loss is
    within rtol 1e-6 of JAX's on a two-device mesh and each vertex within
    1e-6 of its distance from the origin.  (Per coordinate, a few
    coordinates near 0 miss rtol 1e-6: Adam's first steps are
    ``lr g / (|g| + 1e-8)``, so at the smallest gradients, 6e-7, the
    interior gradients' last-bit differences (`test_torch_diff.py`'s bar)
    move a step by up to 7e-8.)"""
    ranks = launch(train_steps, 2, tmp_path, 3, config_kind)
    want = jax_train(config_kind, 3)
    for (p0, l0), (p1, l1) in zip(*ranks):
        assert torch.equal(p0, p1) and torch.equal(l0, l1)
    for k, ((p, loss), (wp, wl)) in enumerate(zip(ranks[0], want)):
        err = np.abs(p.numpy() - wp)
        bar = 1e-6 * np.linalg.norm(wp, axis=1, keepdims=True)
        assert (err <= bar).all(), (k + 1, float((err - bar).max()))
        np.testing.assert_allclose(float(loss), wl, rtol=1e-6,
                                   err_msg=f"loss of step {k + 1}")
    moved = ranks[0][-1][0] != torch.from_numpy(scene_16tris(0)["positions"])
    assert moved.any()
    assert float(ranks[0][-1][1]) < float(ranks[0][0][1])
