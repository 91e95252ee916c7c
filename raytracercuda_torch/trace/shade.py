"""Shading over `Hit` records (counterpart of
`raytracercuda_tpu/trace/shade.py`): attribute interpolation, the
bit-parity packed normal shader and its float-RGB twin, texture sampling,
material albedo, Lambert shading (the generic, differentiable route, the
`FaceTables` route for callers that do not differentiate, and the planar
route over the cluster kernels' outputs with its shadow origins) and
packing."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.mesh import VERTEX_DATA_NORMAL, VERTEX_DATA_UV1
from ..ops.interpolate import face_interpolate
from ..ops.math import as_u32, normalize, pack_rgb
from ..types import FLT_MAX, Hit
from ..utils.profiler import host_copies

#: The miss colour ``255 << 8`` of the packed normal shader.
MISS_COLOR_PACKED = 255 << 8


def interpolate_slot(scene, hit: Hit, slot: int) -> torch.Tensor:
    return face_interpolate(scene.attrs[slot], scene.faces, hit.face, hit.u,
                            hit.v)


def shade_normal_packed(scene, hit: Hit) -> torch.Tensor:
    """Bit-parity normal shading -> packed framebuffer values (uint32):
    ``|n.z * 255|`` truncated toward zero in the red channel on hits,
    ``255 << 8`` on misses (`BuildTree.cu:486-496`)."""
    n = normalize(interpolate_slot(scene, hit, VERTEX_DATA_NORMAL), eps=1e-30)
    red = (n[..., 2] * 255.0).abs().to(torch.int32) << 16
    return as_u32(torch.where(hit.hit_mask, red, MISS_COLOR_PACKED))


def shade_normal_rgb(scene, hit: Hit, background=(0.0, 1.0, 0.0)):
    """Float RGB ``(|n.z|, 0, 0)`` of the interpolated normal on hits,
    ``background`` on misses (a float32 tensor on the hits' device is
    used without a copy from the host)."""
    n = normalize(interpolate_slot(scene, hit, VERTEX_DATA_NORMAL), eps=1e-30)
    r = n[..., 2].abs()
    zero = torch.zeros_like(r)
    rgb = torch.stack([r, zero, zero], dim=-1)
    bg = torch.as_tensor(background, dtype=torch.float32, device=r.device)
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


class FaceTables(NamedTuple):
    """Per-face shading rows: ``rows [F, 13(+6)]`` = n0|n1|n2 (9) | albedo
    (3) | tex_id (1) | optionally uv0|uv1|uv2 (6), so shading a hit is one
    row gather.  Built once per scene; not for differentiating through
    vertex attributes (the generic route keeps the two-level gathers)."""

    rows: torch.Tensor

    @property
    def has_uv(self) -> bool:
        return self.rows.shape[1] >= 19


def build_face_tables(scene) -> FaceTables:
    """Per-face shading rows of ``scene`` (once per scene update)."""
    f = scene.faces.long()
    n = scene.attrs[VERTEX_DATA_NORMAL]
    cols = [n[f[:, 0]], n[f[:, 1]], n[f[:, 2]]]
    mat = scene.mesh_material[f[:, 3]]
    cols.append(scene.albedo[mat])
    cols.append(scene.texture_id[mat].to(torch.float32)[:, None])
    if VERTEX_DATA_UV1 in scene.attrs:
        uv = scene.attrs[VERTEX_DATA_UV1]
        cols += [uv[f[:, 0], :2], uv[f[:, 1], :2], uv[f[:, 2], :2]]
    return FaceTables(rows=torch.cat(cols, dim=1))


def shade_lambert_rgb(scene, hit: Hit, ray_origin: torch.Tensor,
                      ray_dir: torch.Tensor, light_dir=(0.4, 0.8, -0.45),
                      shadow_mask: torch.Tensor | None = None,
                      ambient: float = 0.08,
                      background=(0.0, 1.0, 0.0),
                      tables: Optional[FaceTables] = None) -> torch.Tensor:
    """Lambert N·L shading with optional shadow attenuation -> float RGB
    ``[..., 3]``.  The generic route interpolates, then shades; with
    ``tables`` (`build_face_tables`) each hit is one row gather.  A
    ``light_dir`` or ``background`` given as a float32 tensor on the rays'
    device is used without a copy from the host; host values are copied,
    span ``sync.shade_constants``."""
    del ray_origin  # the JAX signature's; a directional light needs none
    dev = ray_dir.device
    with host_copies("sync.shade_constants", (light_dir, background), dev):
        l = torch.as_tensor(light_dir, dtype=torch.float32, device=dev)
        bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    if tables is not None:
        row = tables.rows[hit.face.clamp(min=0).long()]
        w = 1.0 - (hit.u + hit.v)
        n = (row[:, 0:3] * w[:, None] + row[:, 3:6] * hit.u[:, None]
             + row[:, 6:9] * hit.v[:, None])
        albedo = row[:, 9:12]
        if tables.has_uv:
            tex_id = row[:, 12].to(torch.int32)
            uv = (row[:, 13:15] * w[:, None] + row[:, 15:17] * hit.u[:, None]
                  + row[:, 17:19] * hit.v[:, None])
            tex_rgb = sample_texture(scene.textures, tex_id, uv[:, 0],
                                     uv[:, 1])
            albedo = torch.where((tex_id >= 0)[:, None], albedo * tex_rgb,
                                 albedo)
        n = normalize(n, eps=1e-30)
    else:
        n = normalize(interpolate_slot(scene, hit, VERTEX_DATA_NORMAL),
                      eps=1e-30)
        albedo = None
    # Face the normal against the incoming ray.
    flip = torch.sum(n * ray_dir, dim=-1) > 0.0
    n = torch.where(flip[..., None], -n, n)
    l = normalize(l)
    ndotl = torch.clamp(torch.sum(n * l, dim=-1), min=0.0)
    if shadow_mask is not None:
        ndotl = torch.where(shadow_mask, 0.0, ndotl)
    if albedo is None:
        albedo = material_albedo(scene, hit)
    rgb = albedo * (ambient + (1.0 - ambient) * ndotl)[..., None]
    return torch.where(hit.hit_mask[..., None], rgb, bg)


def faced_ndotl_planar(outs, d3_tiles: torch.Tensor, light: torch.Tensor):
    """Planar kernel outputs ``outs`` (``t``, ..., ``nx, ny, nz`` at 4-6,
    as kernels A and F write them) and ``[T, 3, R]`` directions -> flat
    ``[N]`` ``(hitm, nx, ny, nz, ndotl)``: the normal normalized and faced
    against the ray, ``n.l`` clamped at 0 toward the unit ``light``."""
    nx, ny, nz = (o.reshape(-1) for o in outs[4:7])
    dx = d3_tiles[:, 0, :].reshape(-1)
    dy = d3_tiles[:, 1, :].reshape(-1)
    dz = d3_tiles[:, 2, :].reshape(-1)
    hitm = outs[0].reshape(-1) < FLT_MAX
    # normalize(n, eps=1e-30) per component, then face the ray.
    nlen = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-30))
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen
    flip = nx * dx + ny * dy + nz * dz > 0.0
    nx = torch.where(flip, -nx, nx)
    ny = torch.where(flip, -ny, ny)
    nz = torch.where(flip, -nz, nz)
    ndotl = torch.clamp(nx * light[0] + ny * light[1] + nz * light[2],
                        min=0.0)
    return hitm, nx, ny, nz, ndotl


def lambert_planar(outs, ndotl: torch.Tensor, textures, has_uv: bool,
                   ambient: float):
    """Flat ``[N]`` Lambert ``(r, g, b)`` of planar kernel outputs (albedo
    at 7-9, textured where ``has_uv`` and a texture exist: id, u, v at
    10-12) lit by ``ndotl`` (shadows already applied), before the
    background."""
    ar, ag, ab = (o.reshape(-1) for o in outs[7:10])
    if has_uv and textures is not None and textures.shape[0] > 0:
        tex_id = outs[10].reshape(-1).to(torch.int32)
        tex_rgb = sample_texture(textures, tex_id, outs[11].reshape(-1),
                                 outs[12].reshape(-1))
        texd = tex_id >= 0
        ar = torch.where(texd, ar * tex_rgb[:, 0], ar)
        ag = torch.where(texd, ag * tex_rgb[:, 1], ag)
        ab = torch.where(texd, ab * tex_rgb[:, 2], ab)
    lit = ambient + (1.0 - ambient) * ndotl
    return ar * lit, ag * lit, ab * lit


def shadow_origins_planar(eye: torch.Tensor, d3_tiles: torch.Tensor,
                          t: torch.Tensor, active: torch.Tensor,
                          light: torch.Tensor, eps) -> torch.Tensor:
    """Planar ``[T, 3, R]`` shadow-ray origins of a pinhole frame's tiles
    (``t`` and ``active`` ``[T, R]``): `pipeline.shadow_origins` per
    component, the hit point at ``t`` clamped at 1e6 where ``active``,
    else ``eye``, pushed ``eps`` along ``light``."""
    tmin = torch.clamp(t, max=1e6)
    return torch.stack([
        torch.where(active, eye[i] + d3_tiles[:, i, :] * tmin, eye[i])
        + light[i] * eps for i in range(3)], dim=1)


def pack_shaded(rgb: torch.Tensor) -> torch.Tensor:
    """Float RGB ``[..., 3]`` -> packed ``0x00RRGGBB`` (uint32)."""
    return pack_rgb(rgb[..., 0], rgb[..., 1], rgb[..., 2])
