"""Shading over `Hit` records (counterpart of
`raytracercuda_tpu/trace/shade.py:33-57, 60-98, 144-196`): attribute
interpolation, the float-RGB normal shader, texture sampling, material
albedo and the generic route of Lambert shading, all differentiable.
`FaceTables` serves non-differentiating callers and comes with the
public-API slice of the port."""

from __future__ import annotations

import torch

from ..models.mesh import VERTEX_DATA_NORMAL, VERTEX_DATA_UV1
from ..ops.interpolate import face_interpolate
from ..ops.math import normalize
from ..types import Hit


def interpolate_slot(scene, hit: Hit, slot: int) -> torch.Tensor:
    return face_interpolate(scene.attrs[slot], scene.faces, hit.face, hit.u,
                            hit.v)


def shade_normal_rgb(scene, hit: Hit, background=(0.0, 1.0, 0.0)):
    """Float RGB ``(|n.z|, 0, 0)`` of the interpolated normal on hits,
    ``background`` on misses."""
    n = normalize(interpolate_slot(scene, hit, VERTEX_DATA_NORMAL), eps=1e-30)
    r = n[..., 2].abs()
    zero = torch.zeros_like(r)
    rgb = torch.stack([r, zero, zero], dim=-1)
    bg = torch.tensor(background, dtype=torch.float32, device=r.device)
    return torch.where(hit.hit_mask[..., None], rgb, bg)


def sample_texture(textures: torch.Tensor, tex_id: torch.Tensor,
                   u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch from the ``[T,H,W,3]`` atlas with wrap addressing."""
    t, h, w = textures.shape[0], textures.shape[1], textures.shape[2]
    # torch.remainder, like jnp's %, takes the sign of the divisor.
    fu = torch.remainder(u, 1.0) * (w - 1)
    fv = torch.remainder(v, 1.0) * (h - 1)
    x0 = torch.floor(fu).to(torch.int64)
    y0 = torch.floor(fv).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    ax = (fu - x0)[..., None]
    ay = (fv - y0)[..., None]
    tid = torch.clamp(tex_id.to(torch.int64), 0, t - 1)
    c00 = textures[tid, y0, x0]
    c01 = textures[tid, y0, x1]
    c10 = textures[tid, y1, x0]
    c11 = textures[tid, y1, x1]
    top = c00 * (1 - ax) + c01 * ax
    bot = c10 * (1 - ax) + c11 * ax
    return top * (1 - ay) + bot * ay


def material_albedo(scene, hit: Hit) -> torch.Tensor:
    """Per-hit base colour: the material's albedo, times its texture when
    one is assigned."""
    mesh_id = scene.faces[hit.face.clamp(min=0).long(), 3]
    mat_id = scene.mesh_material[mesh_id]
    albedo = scene.albedo[mat_id]
    tex_id = scene.texture_id[mat_id]
    if VERTEX_DATA_UV1 in scene.attrs:
        uv = interpolate_slot(scene, hit, VERTEX_DATA_UV1)
        tex_rgb = sample_texture(scene.textures, tex_id, uv[..., 0],
                                 uv[..., 1])
        albedo = torch.where((tex_id >= 0)[..., None], albedo * tex_rgb,
                             albedo)
    return albedo


def shade_lambert_rgb(scene, hit: Hit, ray_origin: torch.Tensor,
                      ray_dir: torch.Tensor, light_dir=(0.4, 0.8, -0.45),
                      shadow_mask: torch.Tensor | None = None,
                      ambient: float = 0.08,
                      background=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """Lambert N·L shading with optional shadow attenuation -> float RGB
    ``[..., 3]`` (the generic route: interpolate, then shade)."""
    del ray_origin  # the JAX signature's; a directional light needs none
    dev = ray_dir.device
    n = normalize(interpolate_slot(scene, hit, VERTEX_DATA_NORMAL), eps=1e-30)
    # Face the normal against the incoming ray.
    flip = torch.sum(n * ray_dir, dim=-1) > 0.0
    n = torch.where(flip[..., None], -n, n)
    l = normalize(torch.tensor(light_dir, dtype=torch.float32, device=dev))
    ndotl = torch.clamp(torch.sum(n * l, dim=-1), min=0.0)
    if shadow_mask is not None:
        ndotl = torch.where(shadow_mask, 0.0, ndotl)
    albedo = material_albedo(scene, hit)
    rgb = albedo * (ambient + (1.0 - ambient) * ndotl)[..., None]
    bg = torch.tensor(background, dtype=torch.float32, device=dev)
    return torch.where(hit.hit_mask[..., None], rgb, bg)
