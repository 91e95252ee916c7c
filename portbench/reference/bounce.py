"""The plain reference of a frame with mirror bounces, at a sample of its
pixels, in plain PyTorch.

It follows the program's light model for mirror materials: a surface
blends its local shade with the mirror image by its material's
reflectivity r.  Depth k adds ``T_k (1 - r_k) local_k`` at throughput
``T_{k+1} = T_k r_k`` (``T_0`` = 1); a miss adds ``T_k`` times the
background and ends the path; the last depth takes r = 0, which closes the
sum.

  * Depth 0 is `render.py`'s frame: the binned closest hit of every
    pixel, the hit point's Lambert term with shadow rays from the lit hit
    points (`render.shadow_hits`), and the colour (`render.colour`).
  * A bounce leaves the hit point along the ray's mirror image about the
    interpolated unit normal turned against the ray, its origin pushed
    along that normal by ``t_eps`` times the larger of 1 and the spread of
    the vertex coordinates (``max(positions) - min(positions)``, over
    every axis at once); shadow rays leave from the same push along the
    light.  Bounce rays have no common origin, so each is tested against
    every face (`closest_hits`).  Bounce hits get Lambert without shadows.

Everything past the primary hits is worked out for the sampled pixels
alone.  Every function takes the working ``dtype``, as `render.py`'s do.
"""

from __future__ import annotations

import torch

from .render import (FLT_MAX, RefScene, Shading, _NO_KEY, colour, mt, pack,
                     primary_hits, rotate, shadow_hits, surface,
                     triangle_rows, unit)

#: Ray-triangle tests of the brute-force closest hit evaluated at once.
BRUTE_TESTS = 1 << 24
#: Hit points are at most this far along their ray.
_T_CLAMP = 3.0e37


def push(scene: RefScene, t_eps: float) -> torch.Tensor:
    """The distance that a bounce origin and a shadow origin are pushed
    off the surface: ``t_eps * max(max(positions) - min(positions), 1)``,
    a float32 scalar."""
    p = scene.positions
    spread = torch.clamp(p.max() - p.min(), min=1.0)
    return torch.tensor(t_eps, dtype=torch.float32, device=p.device) * spread


def closest_hits(positions, faces, origins, dirs, active, t_eps, dtype):
    """Closest hit of each active ray ``origins``, ``dirs`` ``[N, 3]``
    over every face: ``(face [N] int64, -1 on a miss or an inactive ray;
    t [N] float32, FLT_MAX there)``, the smaller face id on a tie."""
    dev = dirs.device
    key = torch.full((dirs.shape[0],), _NO_KEY, dtype=torch.int64,
                     device=dev)
    rays = active.nonzero()[:, 0]
    v0, e1, e2 = triangle_rows(positions.to(dtype), faces)
    o, d = origins.to(dtype), dirs.to(dtype)
    nf = faces.shape[0]
    per_block = max(1, BRUTE_TESTS // nf)
    ids = torch.arange(nf, device=dev)
    for r in torch.split(rays, per_block):
        hit, t, _, _ = mt(o[r][:, None], d[r][:, None], v0[None], e1[None],
                          e2[None], t_eps)
        bits = t.to(torch.float32).view(torch.int32).to(torch.int64)
        k = torch.where(hit, (bits << 32) | ids, _NO_KEY)
        key[r] = k.amin(1)
    found = key != _NO_KEY
    face = torch.where(found, key & 0xFFFFFFFF, -1)
    t = torch.where(found, (key >> 32).to(torch.int32).view(torch.float32),
                    FLT_MAX)
    return face, t


def _mirror(origin, d, t, normal, eps):
    """The bounce ray off the hit at ``t``: ``(origin, direction)``."""
    p = origin + d * torch.clamp(t, max=_T_CLAMP).to(d.dtype)[:, None]
    n = normal
    dn = d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1] + d[:, 2] * n[:, 2]
    return p + n * eps.to(d.dtype), d - (2.0 * dn)[:, None] * n


def render_sample(scene: RefScene, eye, orient, rays, width, height,
                  shading: Shading, shadows: bool, bounces: int,
                  sample: torch.Tensor, dtype=torch.float32):
    """The packed colours ``[S]`` int64 of the pixels ``sample`` (indices
    into the row-major frame) with ``bounces`` mirror bounces, and the
    same pixels packed at depth 0 alone (what they would read without
    the bounces)."""
    with torch.no_grad():
        dev = rays.device
        d_all = rotate(rays, orient)
        face, t = primary_hits(scene.positions, scene.faces, eye, orient,
                               d_all, width, height, shading.t_eps, dtype)
        face, t, d = face[sample], t[sample], d_all[sample]
        hit = face >= 0
        light = unit(torch.tensor(shading.light, dtype=torch.float32,
                                  device=dev))
        eps = push(scene, shading.t_eps)
        pos = scene.positions.to(dtype)
        tex = scene.textures.to(dtype)
        s = surface(scene, pos, face, hit, eye.to(dtype), d.to(dtype), light,
                    dtype)
        shadow = torch.zeros_like(hit)
        if shadows:
            lit = hit & (s.ndotl > 0.0)
            tmin = torch.clamp(t, max=1e6)[:, None]
            so = torch.where(lit[:, None], eye + d * tmin, eye) + light * eps
            shadow = shadow_hits(scene.positions, scene.faces, so, lit, light,
                                 shading.t_eps, dtype)
        local = colour(scene, tex, s, face, hit, shadow, shading, dtype)
        flat = pack(local)
        if bounces == 0:
            return flat, flat

        refl = scene.face_reflectivity.to(dtype)

        def reflectivity(face, hit):
            return torch.where(hit, refl[face.clamp(min=0)], 0.0)

        r = reflectivity(face, hit)
        rgb = (1.0 - r)[:, None] * local
        throughput = r
        active = hit & (r > 0.0)
        o, d = _mirror(eye.to(dtype).expand(d.shape), d.to(dtype), t,
                       s.normal, eps)
        no_shadow = torch.zeros_like(hit)
        for b in range(bounces):
            face, t = closest_hits(scene.positions, scene.faces, o, d, active,
                                   shading.t_eps, dtype)
            hit = face >= 0
            s = surface(scene, pos, face, hit, o, d, light, dtype)
            local = colour(scene, tex, s, face, hit, no_shadow, shading,
                           dtype)
            r = (torch.zeros_like(throughput) if b == bounces - 1
                 else reflectivity(face, hit))
            weight = torch.where(active, throughput * (1.0 - r), 0.0)
            rgb = rgb + weight[:, None] * local
            throughput = throughput * r
            o, d = _mirror(o, d, t, s.normal, eps)
            active = active & hit & (r > 0.0)
        return pack(rgb), flat
