"""Multi-bounce (mirror-reflection) rendering (counterpart of
`raytracercuda_tpu/trace/bounce.py`).

Light model (energy-conserving): each surface blends its local Lambert
shade with the incoming mirror radiance by its material ``reflectivity``,
``L = (1-r)*local + r*bounce``.  A hit at depth k contributes
``T_k * (1-r_k) * local_k`` with throughput ``T_{k+1} = T_k * r_k``; a miss
contributes ``T_k * background`` and ends the path; the last depth
contributes its local shade at the whole remaining throughput (r taken as
0), which closes the sum.

`render_bounces` has two routes with the same light model:

  * the cluster route, `bounce_sweep.render_bounces_tiled` on kernels A, B
    and F, for a frame edge-padded to whole tiles and cropped after;
  * ``use_brute=True``, the oracle: every trace goes through
    `bruteforce.trace_brute` (kernel E), in the JAX package's control flow.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..models.mesh import VERTEX_DATA_NORMAL
from ..ops.math import normalize
from ..types import Hit
from ..utils.profiler import host_copies, span
from .pipeline import crop_frame, occlusion_hit, pad_frame, shadow_origins
from .shade import interpolate_slot, shade_lambert_rgb


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror ``d`` about the unit normal ``n`` (rowwise ``[..., 3]``)."""
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def _hit_reflectivity(scene, hit: Hit) -> torch.Tensor:
    """Each hit's material reflectivity, 0 on misses."""
    if scene.reflectivity is None:
        return torch.zeros(hit.face.shape, dtype=torch.float32,
                           device=hit.face.device)
    mesh_id = scene.faces[hit.face.clamp(min=0).long(), 3]
    mat_id = scene.mesh_material[mesh_id]
    return torch.where(hit.hit_mask, scene.reflectivity[mat_id], 0.0)


def _bounce_geometry(scene, hit: Hit, origin, direction, eps):
    """New (origin, direction) after a mirror bounce off the normal faced
    against the ray, the origin offset by ``eps`` along it."""
    n = normalize(interpolate_slot(scene, hit, VERTEX_DATA_NORMAL), eps=1e-30)
    flip = torch.sum(n * direction, dim=-1) > 0.0
    n = torch.where(flip[..., None], -n, n)
    p = origin + direction * torch.clamp(hit.t, max=3e37)[..., None]
    return p + n * eps, reflect(direction, n)


def render_bounces(
    cs,
    scene,
    eye: torch.Tensor,
    dirs: torch.Tensor,
    height: int,
    width: int,
    config: RenderConfig,
    num_bounces: int = 2,
    light_dir=(0.4, 0.8, -0.45),
    with_shadows: bool = True,
    background=(0.0, 1.0, 0.0),
    use_brute: bool = False,
) -> torch.Tensor:
    """Pinhole frame with ``num_bounces`` mirror bounces -> ``[H*W, 3]``
    float RGB.  ``dirs`` are row-major ``[H*W, 3]`` directions from
    ``eye``; ``cs`` is the scene's cluster set (unused with
    ``use_brute``).  Callers rendering many frames should build the shade
    blocks once and call `render_bounces_tiled` directly."""
    with span("frame"):
        if use_brute:
            return _render_brute(scene, eye, dirs, config, num_bounces,
                                 light_dir, with_shadows, background)
        from .bounce_sweep import render_bounces_tiled
        from .sweep import shade_segment_blocks

        tc = config.trace
        # Frames that the tile does not divide are edge-padded and cropped
        # (1080 rows pad to 1088): the repeated edge rays are valid
        # directions, and their pixels are discarded.
        tp = tc.dense_tile_px
        d, hp, wp = pad_frame(dirs, height, width, tp)
        with span("bounce.blocks"):
            blocks, has_uv = shade_segment_blocks(cs, scene)
        rgb = render_bounces_tiled(
            cs, blocks, has_uv, scene.textures, eye, d, hp, wp, tile_px=tp,
            num_bounces=num_bounces, light_dir=light_dir,
            with_shadows=with_shadows, background=background, trace_cfg=tc)
        return crop_frame(rgb, height, width, hp, wp)


def _render_brute(scene, eye, dirs, config, num_bounces, light_dir,
                  with_shadows, background) -> torch.Tensor:
    """`render_bounces`'s ``use_brute`` route."""
    from .bruteforce import trace_brute

    tc = config.trace
    dev = dirs.device
    with host_copies("sync.constants", (tc.t_epsilon, light_dir), dev):
        t_eps = torch.tensor(tc.t_epsilon, dtype=torch.float32, device=dev)
        light = torch.tensor(light_dir, dtype=torch.float32, device=dev)
    eps = t_eps * torch.clamp(scene.positions.max() - scene.positions.min(),
                              min=1.0)
    light = normalize(light)
    origin = eye[None, :].expand(dirs.shape)
    hit = trace_brute(scene.positions, scene.faces, origin, dirs, tc)

    shadow = None
    if with_shadows:
        # No structure: E, as for the primary rays.
        hit_mask = hit.hit_mask
        so = shadow_origins(origin, dirs, hit.t, hit_mask, light, eps, 3e37)
        shadow = occlusion_hit(scene, None, so, light, hit_mask, config)

    local0 = shade_lambert_rgb(scene, hit, origin, dirs, light_dir=light_dir,
                               shadow_mask=shadow, background=background)
    refl = _hit_reflectivity(scene, hit)  # 0 at misses: whole local or bg
    if num_bounces == 0:
        return local0  # depth 0 is the last depth
    rgb = (1.0 - refl[..., None]) * local0
    throughput = refl[..., None]
    o, d = _bounce_geometry(scene, hit, origin, dirs, eps)
    active = hit.hit_mask & (refl > 0.0)

    for b in range(num_bounces):
        # The JAX route first moves active rays to the front (an argsort)
        # for its cluster sweep's chunks.  A brute-force hit is computed per
        # ray, so that permutation cannot change one and is left out.
        hit = trace_brute(scene.positions, scene.faces, o, d, tc)
        hit = Hit(t=torch.where(active, hit.t, 3.4e38), u=hit.u, v=hit.v,
                  face=torch.where(active, hit.face, -1))
        local = shade_lambert_rgb(scene, hit, o, d, light_dir=light_dir,
                                  background=background)
        refl = _hit_reflectivity(scene, hit)  # 0 at misses
        if b == num_bounces - 1:
            # The last depth emits its local shade at the whole remaining
            # throughput (r taken as 0), so path weights sum to 1.
            refl = torch.zeros_like(refl)
        rgb = rgb + torch.where(
            active[..., None], throughput * (1.0 - refl[..., None]) * local,
            0.0)
        throughput = throughput * refl[..., None]
        o, d = _bounce_geometry(scene, hit, o, d, eps)
        active = active & hit.hit_mask & (refl > 0.0)

    return rgb
