"""Sharded render and training steps over a process group (counterpart of
`raytracercuda_tpu/parallel/shard.py`).

Every function takes the same replicated inputs as the JAX package's.  Rank
``r`` of ``n`` works on rows ``[r R / n, (r + 1) R / n)`` of the rays
(`mesh.ray_sharding`); with ``frame_hw`` ``(H, W)`` that band is an
``(H / n, W)`` sub-frame, so the tile routes (kernels A, B, C, H; L on
BVH, M on GRID) run on each band.  The scene and its structure are
replicated, so the forward pass needs no communication.  The outputs are
gathered (`mesh.all_gather_rays`), and each rank's caller gets what the
JAX caller gets.  The training step all-reduces the gradients and the
loss with SUM before the optimizer step, so every rank holds the same
parameters afterwards.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..diff.render_grad import render_rgb
from .mesh import all_gather_rays, ray_sharding


def _local_hw(frame_hw, mesh):
    """The band's ``(H / n, W)``; the mesh size must divide H."""
    if frame_hw is None:
        return None
    h, w = frame_hw
    n = mesh.size()
    if h % n:
        raise ValueError(f"frame height {h} not divisible by {n} ranks")
    return h // n, w


def render_sharded(scene, accel, initial_rays: torch.Tensor,
                   eye: torch.Tensor, orient: torch.Tensor,
                   config: RenderConfig, mesh, shading: str = "lambert",
                   with_shadows: bool = False,
                   frame_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Forward render with the rays sharded over the mesh -> ``[R, 3]``
    RGB on every rank.  The mesh size must divide ``R`` (use
    `mesh.pad_rays_for_mesh`); with ``frame_hw`` each rank renders its
    pixel band as a sub-frame."""
    rgb = render_rgb(scene, accel, ray_sharding(mesh, initial_rays), eye,
                     orient, config, shading=shading,
                     with_shadows=with_shadows,
                     frame_hw=_local_hw(frame_hw, mesh))
    return all_gather_rays(mesh, rgb)


class Optimizer(NamedTuple):
    """A `torch.optim` optimizer used functionally, as an optax
    transformation is: ``make(tensors)`` builds one over a list of
    tensors; ``init(params)`` is the state of no steps (its
    ``state_dict()``)."""

    make: Callable

    def init(self, params: dict) -> dict:
        return self.make(list(params.values())).state_dict()


#: The JAX package's default, `optax.adam(1e-2)`: b1 0.9, b2 0.999, eps
#: 1e-8 outside the square root, no weight decay.
ADAM = Optimizer(functools.partial(torch.optim.Adam, lr=1e-2,
                                   betas=(0.9, 0.999), eps=1e-8,
                                   weight_decay=0.0))


def graft(scene, params: dict):
    """``params`` (``positions``, ``albedo``, ``textures``, ``normals``,
    the latter into attribute slot 1) grafted onto the scene."""
    rep = {k: params[k] for k in ("positions", "albedo", "textures")
           if k in params}
    if "normals" in params:
        rep["attrs"] = {**scene.attrs, 1: params["normals"]}
    return scene._replace(**rep)


def make_train_step(config: RenderConfig, mesh, optimizer: Optimizer = None,
                    shading: str = "lambert", with_shadows: bool = False,
                    frame_hw: tuple[int, int] | None = None,
                    psum_grads: bool = True):
    """A distributed inverse-rendering step.  Returns ``(step,
    optimizer)``; ``step(params, opt_state, scene, accel, rays, eye,
    orient, target)`` returns ``(params, opt_state, loss)``.

    ``params`` is a dict of tensors grafted onto the replicated scene
    (`graft`); ``opt_state`` is the optimizer's ``state_dict()``
    (``optimizer.init(params)`` to start), and neither input is modified.
    Each rank renders its band; the local loss is ``sum((img - target)^2)
    / (R * 3)`` over all ``R`` rays, and the gradients and the loss are
    all-reduced with SUM, so every rank takes the same step.
    ``psum_grads=False`` skips the all-reduce; the step is then wrong on
    more than one rank and exists to time the collective."""
    if optimizer is None:
        optimizer = ADAM
    local_hw = _local_hw(frame_hw, mesh)

    def step(params, opt_state, scene, accel, rays, eye, orient, target):
        names = list(params)
        leaves = [params[k].detach().clone().requires_grad_() for k in names]
        opt = optimizer.make(leaves)
        opt.load_state_dict(copy.deepcopy(opt_state))
        img = render_rgb(graft(scene, dict(zip(names, leaves))), accel,
                         ray_sharding(mesh, rays), eye, orient, config,
                         shading=shading, with_shadows=with_shadows,
                         frame_hw=local_hw)
        loss = torch.sum((img - ray_sharding(mesh, target)) ** 2) \
            / (rays.shape[0] * 3)
        loss.backward()
        loss = loss.detach()
        if psum_grads and mesh.size() > 1:
            group = mesh.get_group()
            for x in leaves:
                if x.grad is None:
                    x.grad = torch.zeros_like(x)
                dist.all_reduce(x.grad, op=dist.ReduceOp.SUM, group=group)
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        opt.step()
        return ({k: x.detach() for k, x in zip(names, leaves)},
                opt.state_dict(), loss)

    return step, optimizer


def render_bounces_sharded(cs, scene, eye: torch.Tensor, dirs: torch.Tensor,
                           height: int, width: int, config: RenderConfig,
                           mesh, num_bounces: int = 2,
                           light_dir=(0.4, 0.8, -0.45),
                           with_shadows: bool = True,
                           background=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """The multi-bounce pinhole frame with the rays sharded as pixel bands:
    every bounce of a band runs on its rank (bounce rays stay home, so no
    communication), then the bands are gathered."""
    from ..trace.bounce import render_bounces

    local_h, _ = _local_hw((height, width), mesh)
    rgb = render_bounces(cs, scene, eye, ray_sharding(mesh, dirs), local_h,
                         width, config, num_bounces=num_bounces,
                         light_dir=light_dir, with_shadows=with_shadows,
                         background=background)
    return all_gather_rays(mesh, rgb)


def progressive_step_sharded(state, scene, accel, eye: torch.Tensor,
                             orient: torch.Tensor, width: int, height: int,
                             config: RenderConfig, mesh,
                             shading: str = "lambert",
                             with_shadows: bool = False, zoom: float = 1.0):
    """One progressive-accumulation step with pixel bands over the ranks.
    Each band only adds its own samples, so the result is bit-identical to
    `progressive_step`'s."""
    from ..trace.progressive import ProgressiveState, halton, \
        jittered_ray_grid

    jx = halton(state.count + 1, 2)
    jy = halton(state.count + 1, 3)
    rays = jittered_ray_grid(width, height, jx, jy, zoom=zoom,
                             device=state.accum.device)
    rgb = render_rgb(scene, accel, ray_sharding(mesh, rays), eye, orient,
                     config, shading=shading, with_shadows=with_shadows,
                     frame_hw=_local_hw((height, width), mesh))
    accum = all_gather_rays(mesh, ray_sharding(mesh, state.accum) + rgb)
    return ProgressiveState(accum=accum, count=state.count + 1)
