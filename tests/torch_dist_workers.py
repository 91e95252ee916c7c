"""Workers of the port's distributed tests (`test_torch_parallel.py`,
`test_torch_ring.py`): each runs in its own process, one per rank, over
gloo on the CPU, and writes what it computed to ``rank<r>.pt`` in the
test's directory.  This module imports the port and never jax, so that the
spawned processes start quickly and stay off the JAX runtime.

`launch` spawns the ranks with `torch.multiprocessing` (the spawn start
method), rendezvous through a ``file://`` store in the test's own
directory (so concurrent test workers never share a port), and fails after
its time limit.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


def launch(fn, world: int, directory, *args, timeout: float = 120.0):
    """Run ``fn(rank, world, directory, *args)`` on ``world`` gloo ranks;
    returns each rank's saved result, in rank order."""
    import torch.multiprocessing as mp

    directory = str(directory)
    ctx = mp.start_processes(_entry, args=(fn, world, directory, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks took "
                                   f"over {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(os.path.join(directory, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _entry(rank, fn, world, directory, args):
    import torch.distributed as dist

    from raytracercuda_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    store = os.path.join(directory, "store")
    assert initialize_distributed(init_method=f"file://{store}",
                                  world_size=world, rank=rank,
                                  backend="gloo")
    try:
        out = fn(rank, world, directory, *args)
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Scenes, made from seeds with numpy (the tests build the same ones).
# ---------------------------------------------------------------------------


def scene_16tris(seed: int = 0) -> dict:
    """`test_parallel.scene_16tris` as numpy fields."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.5, 1.5, (16, 3)).astype(np.float32)
    base[:, 2] = np.abs(base[:, 2]) + 2.0
    offs = rng.normal(scale=0.4, size=(16, 2, 3)).astype(np.float32)
    verts = np.concatenate([base[:, None], base[:, None] + offs],
                           axis=1).reshape(-1, 3)
    faces = np.concatenate([np.arange(48, dtype=np.int32).reshape(-1, 3),
                            np.zeros((16, 1), np.int32)], axis=1)
    normals = rng.normal(size=(48, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return dict(positions=verts, faces=faces, attrs={1: normals},
                mesh_material=np.zeros(1, np.int32),
                albedo=np.array([[0.7, 0.7, 0.7]], np.float32),
                texture_id=np.array([-1], np.int32),
                textures=np.zeros((1, 1, 1, 3), np.float32))


def reflective_scene(seed: int = 2, num: int = 24) -> dict:
    """`test_parallel.reflective_scene` as numpy fields: two meshes'
    worth of triangles with reflective materials."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.5, 1.5, (num, 3)).astype(np.float32)
    base[:, 2] = np.abs(base[:, 2]) + 2.0
    offs = rng.normal(scale=0.5, size=(num, 2, 3)).astype(np.float32)
    verts = np.concatenate([base[:, None], base[:, None] + offs],
                           axis=1).reshape(-1, 3)
    faces = np.concatenate([np.arange(num * 3, dtype=np.int32).reshape(-1, 3),
                            (np.arange(num, dtype=np.int32) % 2)[:, None]],
                           axis=1)
    normals = rng.normal(size=(num * 3, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return dict(positions=verts, faces=faces, attrs={1: normals},
                mesh_material=np.array([0, 1], np.int32),
                albedo=np.array([[0.7, 0.5, 0.3], [0.2, 0.6, 0.9]],
                                np.float32),
                texture_id=np.array([-1, -1], np.int32),
                textures=np.zeros((1, 1, 1, 3), np.float32),
                reflectivity=np.array([0.5, 0.25], np.float32))


def tri_soup(n: int = 600, seed: int = 3):
    """`test_ring.random_tri_soup` as numpy arrays."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    base[:, 2] += 4.0
    offs = rng.normal(scale=0.3, size=(n, 2, 3)).astype(np.float32)
    verts = np.concatenate([base[:, None], base[:, None] + offs],
                           axis=1).reshape(-1, 3)
    faces = np.concatenate([np.arange(3 * n, dtype=np.int32).reshape(-1, 3),
                            np.zeros((n, 1), np.int32)], axis=1)
    return verts, faces


def tie_clusters():
    """`test_ring.py:110`'s cluster set of eight clusters of 8 slots: one
    triangle in cluster 0 (face 5) and its copy in cluster 7 (face 9), far
    point boxes elsewhere.  Returns ``(cmin, cmax, tris, face_order)``."""
    L = 8
    tri = np.array([-1.0, -1.0, 3.0, 2.0, -1.0, 3.0, -1.0, 2.0, 3.0],
                   np.float32)
    tris = np.zeros((8, L, 9), np.float32)
    tris[0, 0] = tris[7, 0] = tri
    v = tri.reshape(3, 3)
    cmin = np.full((8, 3), 3.0e37, np.float32)
    cmax = np.full((8, 3), 3.0e37, np.float32)
    cmin[[0, 7]] = v.min(axis=0)
    cmax[[0, 7]] = v.max(axis=0)
    face_order = np.full(8 * L, -1, np.int64)
    face_order[0] = 5
    face_order[7 * L] = 9
    return cmin, cmax, tris, face_order


# ---------------------------------------------------------------------------
# Rank bodies.
# ---------------------------------------------------------------------------


def sharded_renders(rank, world, directory):
    """`render_sharded` (CLUSTER frame bands and bundles, BVH bundles),
    `render_bounces_sharded` and two `progressive_step_sharded` steps."""
    from raytracercuda_torch import interop
    from raytracercuda_torch.accel.bvh import build_bvh
    from raytracercuda_torch.accel.clusters import build_clusters
    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.parallel.mesh import make_ray_mesh
    from raytracercuda_torch.parallel.shard import (progressive_step_sharded,
                                                    render_bounces_sharded,
                                                    render_sharded)
    from raytracercuda_torch.trace.pipeline import rotate_rays
    from raytracercuda_torch.trace.progressive import init_progressive

    mesh = make_ray_mesh(world)
    eye, orient = torch.zeros(3), torch.eye(3)
    cluster = RenderConfig(accel=AccelKind.CLUSTER)
    bvh = RenderConfig(accel=AccelKind.BVH)
    scene = interop.scene_from_numpy(**scene_16tris(5), device="cpu")
    cs = build_clusters(scene.positions, scene.faces, cluster.cluster)
    tree = build_bvh(scene.positions, scene.faces, bvh.bvh)
    h, w = 16 * world * 2, 32
    rays = camera_ray_grid(w, h, device="cpu")
    out = {
        "frame": render_sharded(scene, cs, rays, eye, orient, cluster, mesh,
                                with_shadows=True, frame_hw=(h, w)),
        "bundle": render_sharded(scene, cs, rays, eye, orient, cluster,
                                 mesh),
        "bvh": render_sharded(scene, tree, rays, eye, orient, bvh, mesh),
    }
    refl = interop.scene_from_numpy(**reflective_scene(), device="cpu")
    rcs = build_clusters(refl.positions, refl.faces, cluster.cluster)
    out["bounces"] = render_bounces_sharded(
        rcs, refl, eye, rotate_rays(rays, orient), h, w, cluster, mesh,
        num_bounces=2)
    st = init_progressive(h * w, device="cpu")
    for _ in range(2):
        st = progressive_step_sharded(st, scene, cs, eye, orient, w, h,
                                      cluster, mesh)
    out["progressive"] = st
    return out


def train_steps(rank, world, directory, steps: int, config_kind: str):
    """``steps`` steps of `make_train_step` (Adam at lr 1e-2) on
    `scene_16tris` toward a zero target, 32x32 rays; the params and loss
    after each."""
    from raytracercuda_torch import interop
    from raytracercuda_torch.accel.bvh import build_bvh
    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.parallel.mesh import make_ray_mesh
    from raytracercuda_torch.parallel.shard import make_train_step

    config = RenderConfig(accel=AccelKind[config_kind])
    scene = interop.scene_from_numpy(**scene_16tris(0), device="cpu")
    accel = (build_bvh(scene.positions, scene.faces, config.bvh)
             if config.accel == AccelKind.BVH else None)
    rays = camera_ray_grid(32, 32, device="cpu")
    target = torch.zeros((rays.shape[0], 3))
    mesh = make_ray_mesh(world)
    step, optimizer = make_train_step(config, mesh)
    params = {"positions": scene.positions}
    opt_state = optimizer.init(params)
    history = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, scene, accel, rays,
                                       torch.zeros(3), torch.eye(3), target)
        history.append((params["positions"].clone(), loss.clone()))
    return history


def ring_traces(rank, world, directory, soup_faces: int, cluster_size: int,
                side: int):
    """`trace_ring_sharded` on a padded triangle soup: all rays, every
    other ray active, and `any_hit_ring_sharded`; then on `tie_clusters`
    (padded to the ring)."""
    from raytracercuda_torch.accel.clusters import ClusterSet, build_clusters
    from raytracercuda_torch.config import ClusterConfig, TraceConfig
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.parallel.mesh import pad_rays_for_mesh
    from raytracercuda_torch.types import Hit
    from raytracercuda_torch.parallel.ring import (any_hit_ring_sharded,
                                                   make_ring_mesh,
                                                   pad_clusters_for_ring,
                                                   trace_ring_sharded)

    mesh = make_ring_mesh(world)
    verts, faces = tri_soup(soup_faces)
    cs = build_clusters(torch.from_numpy(verts), torch.from_numpy(faces),
                        ClusterConfig(cluster_size=cluster_size))
    cs = pad_clusters_for_ring(cs, world)
    dirs = camera_ray_grid(side, side, device="cpu")
    origin = torch.tensor([0.1, -0.2, 0.0]).expand(dirs.shape)
    active = torch.arange(dirs.shape[0]) % 2 == 0
    tc = TraceConfig()
    out = {"all": trace_ring_sharded(cs, origin, dirs, mesh, tc),
           "active": trace_ring_sharded(cs, origin, dirs, mesh, tc,
                                        active=active),
           "occluded": any_hit_ring_sharded(
               cs, origin, dirs, torch.full(dirs.shape[:1], 1e6), mesh, tc)}
    cmin, cmax, tris, face_order = (torch.from_numpy(x)
                                    for x in tie_clusters())
    tie = pad_clusters_for_ring(ClusterSet(cmin=cmin, cmax=cmax, tris=tris,
                                           face_order=face_order), world)
    # 64 rays: at three ranks they are padded to 66 (`pad_rays_for_mesh`).
    tdirs, r = pad_rays_for_mesh(camera_ray_grid(8, 8, device="cpu"), mesh)
    tie_hit = trace_ring_sharded(tie, torch.zeros_like(tdirs), tdirs, mesh,
                                 tc)
    out["tie"] = Hit(*(x[:r] for x in tie_hit))
    return out
