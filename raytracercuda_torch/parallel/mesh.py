"""Process-group helpers for ray sharding (counterpart of
`raytracercuda_tpu/parallel/mesh.py`).

The JAX package runs one process over many devices and shards arrays over
a mesh axis named ``"rays"``.  The port runs one process per rank
(`torch.distributed`): the mesh is a 1-D `DeviceMesh` over the process
group, and a rank works on its contiguous band of the leading axis
(`ray_sharding`) of inputs every rank holds whole (`replicated`).  The
scene and its structure are replicated.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

RAY_AXIS = "rays"


def make_ray_mesh(num_devices: int | None = None, axis: str = RAY_AXIS):
    """A 1-D `DeviceMesh` over the process group, axis ``"rays"``: NCCL
    ranks on the card, gloo ranks on the CPU.  ``num_devices``, when
    given, must be the group's size (one device a rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_ray_mesh needs an initialized process "
                           "group: call initialize_distributed first")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices {num_devices} != world size {world}: "
                         "a rank drives one device")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (world,), mesh_dim_names=(axis,))


def ray_sharding(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous band of ``x``'s leading axis, rows ``[r n /
    size, (r + 1) n / size)`` (JAX: the ``P("rays")`` sharding); the mesh
    size must divide ``n``."""
    n, size = x.shape[0], mesh.size()
    if n % size:
        raise ValueError(f"leading axis {n} not divisible by the mesh size "
                         f"{size}; call pad_rays_for_mesh first")
    r = mesh.get_local_rank()
    return x[r * n // size:(r + 1) * n // size]


def replicated(mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole of ``x``, which every rank holds (JAX: ``P()``)."""
    del mesh
    return x


def all_gather_rays(mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' bands of a leading axis, concatenated in rank order: the
    whole array on every rank."""
    if mesh.size() == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=mesh.get_group())
    return torch.cat(parts)


def pad_rays_for_mesh(rays: torch.Tensor, mesh):
    """Pad the leading (ray) axis with zeros to a multiple of the mesh
    size.  Returns ``(padded_rays, original_count)``."""
    n = mesh.size()
    r = rays.shape[0]
    rem = (-r) % n
    if rem:
        rays = torch.cat([rays, rays.new_zeros((rem,) + tuple(rays.shape[1:]))])
    return rays, r


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None) -> bool:
    """Bring up the process group (`torch.distributed.init_process_group`).

    Returns True when a multi-process group is up.  A no-op returning False
    only when no launch is configured: no ``init_method`` and neither
    torchrun's ``MASTER_ADDR`` nor ``WORLD_SIZE`` in the environment.  A
    configured launch that fails raises: falling back to one process after
    a real multi-process failure would have every rank render the whole
    frame.  The backend is named: NCCL where CUDA is available (each rank
    then takes card ``LOCAL_RANK``, else ``rank`` modulo the count), gloo
    on the CPU."""
    configured = (init_method is not None or "MASTER_ADDR" in os.environ
                  or "WORLD_SIZE" in os.environ)
    if not configured:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
            else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return True
