"""The reference's inverse-rendering steps: the mean squared error of
`render.render_rgb` against a target, its gradient by autograd, and Adam,
written out."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .render import RefScene, Shading, render_rgb


class AdamSettings(NamedTuple):
    lr: float
    b1: float
    b2: float
    eps: float


class Steps(NamedTuple):
    losses: list  # float per step
    grads: list  # the first step's gradient of each leaf
    change: list  # each leaf's change over the steps


def adam_steps(scene: RefScene, eye, orient, rays, width, height, target,
               shading: Shading, adam: AdamSettings, steps: int,
               dtype=torch.float32) -> Steps:
    """``steps`` Adam steps on (positions, textures) from the scene's own,
    each on the loss of a fresh render: ``(losses, first gradients,
    changes)``."""
    start = [scene.positions.detach().clone(),
             scene.textures.detach().clone()]
    leaves = [x.clone() for x in start]
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    losses, first = [], None
    for step in range(1, steps + 1):
        live = [x.detach().requires_grad_() for x in leaves]
        img = render_rgb(scene._replace(positions=live[0], textures=live[1]),
                         eye, orient, rays, width, height, shading, True,
                         dtype)
        loss = torch.mean((img.to(torch.float32) - target) ** 2)
        grads = torch.autograd.grad(loss, live)
        losses.append(float(loss.detach()))
        if first is None:
            first = [g.detach().clone() for g in grads]
        with torch.no_grad():
            bc1 = 1.0 - adam.b1 ** step
            bc2 = 1.0 - adam.b2 ** step
            for x, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(adam.b1).add_(g, alpha=1.0 - adam.b1)
                vi.mul_(adam.b2).add_(g * g, alpha=1.0 - adam.b2)
                x.sub_(adam.lr / bc1 * mi / (vi.sqrt() / bc2 ** 0.5
                                             + adam.eps))
    return Steps(losses, first, [x - s for x, s in zip(leaves, start)])
