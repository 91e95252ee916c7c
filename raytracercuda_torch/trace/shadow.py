"""Light-space basis for directional shadows (counterpart of
`raytracercuda_tpu/trace/shadow.py:41-52`).  The light-space shadow grid
comes with a later slice of the port."""

from __future__ import annotations

import torch

from ..ops.math import cross


def light_basis(light_dir: torch.Tensor):
    """Orthonormal (u, v, l) with l along the light direction."""
    l = light_dir / torch.linalg.vector_norm(light_dir)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=l.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=l.device)
    u = cross(l, torch.where(l[0].abs() < 0.9, ex, ey))
    u = u / torch.linalg.vector_norm(u)
    v = cross(l, u)
    return u, v, l
