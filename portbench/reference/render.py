"""The plain reference: pinhole frames, shadows, Lambert shading and the
differentiable image of a triangle scene, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
is given the benchmark's own inputs (vertex arrays, faces, materials,
textures, camera, light) and works out everything else itself.  It shares
no algorithm with the program's acceleration structures: every ray is
tested against every triangle whose projected box holds it, found by
binning.

  * Primary rays leave one eye; a triangle can be hit by the ray of pixel
    (i, j) only if its vertices' projection onto the image plane, boxed
    and widened by one pixel, holds that pixel.
  * Shadow rays run along one light direction; a triangle can block the
    ray from origin o only if its projection along the light onto a plane
    across it, boxed and widened by one cell of a grid laid over the
    origins, holds o's cell.

Each candidate pair gets the Moller-Trumbore test.  A ray's closest hit
is its smallest t, ties going to the smaller face id; a shadow ray is
blocked by any hit at t >= t_eps.  Shading follows the renderer's rules:
interpolated vertex normal facing the eye, Lambert against a directional
light, textures sampled bilinearly with wrap addressing, an ambient term
and a background colour; frames pack 0x00RRGGBB with each channel clipped
to [0, 255] and truncated.

Every function takes the working ``dtype``: float32 for the reference,
bfloat16 for the control that must come out wrong.  Binning is always
done in float32, so the candidates are the same in both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FLT_MAX = float(np.float32(3.4028234663852886e38))
#: Determinants below the smallest normal float32 count as a miss.
DET_TINY = 1.1754944e-38
_NO_KEY = torch.iinfo(torch.int64).max
#: Candidate ray-triangle tests evaluated at once.
CHUNK_TESTS = 1 << 22


class RefScene(NamedTuple):
    positions: torch.Tensor  # [V, 3] float32
    faces: torch.Tensor  # [F, 3] int64
    normals: torch.Tensor  # [V, 3] float32
    uvs: torch.Tensor  # [V, 2] float32
    face_material: torch.Tensor  # [F] int64
    albedo: torch.Tensor  # [M, 3] float32
    texture_id: torch.Tensor  # [M] int64, -1 untextured
    textures: torch.Tensor  # [T, H, W, 3] float32
    face_reflectivity: torch.Tensor  # [F] float32, mirror share (bounce.py)


class Shading(NamedTuple):
    light: tuple  # direction toward the light (not normalised)
    ambient: float
    background: tuple
    t_eps: float  # hits nearer than this miss


def camera_rays(width: int, height: int, jitter=(0.5, 0.5), zoom: float = 1.0,
                device=None) -> torch.Tensor:
    """Unit directions ``[H*W, 3]`` in camera space, row-major from the
    top row: the ray of pixel (i, j) passes through (j + jx, i + jy) of a
    window [-1, 1]^2 at distance ``zoom``."""
    f32 = torch.float32
    jx = torch.tensor(jitter[0], dtype=f32, device=device)
    jy = torch.tensor(jitter[1], dtype=f32, device=device)
    rx = -1.0 + (2.0 / width) * (torch.arange(width, dtype=f32,
                                              device=device) + jx)
    ry = 1.0 + (-2.0 / height) * (torch.arange(height, dtype=f32,
                                               device=device) + jy)
    gx = rx[None, :].expand(height, width)
    gy = ry[:, None].expand(height, width)
    d = 1.0 / torch.sqrt(zoom * zoom + gx * gx + gy * gy)
    gz = torch.full_like(gx, zoom)
    return torch.stack([gx * d, gy * d, gz * d], -1).reshape(-1, 3)


def halton(index: int, base: int) -> float:
    """The radical inverse of ``index`` in ``base``, rounded to float32."""
    r, f = 0.0, 1.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return float(np.float32(r))


def rotate(rays: torch.Tensor, orient: torch.Tensor) -> torch.Tensor:
    """World directions ``orient @ ray`` of camera-space ``[N, 3]``
    rays."""
    return (rays[:, 0:1] * orient[:, 0] + rays[:, 1:2] * orient[:, 1]
            + rays[:, 2:3] * orient[:, 2])


def mt(o, d, v0, e1, e2, t_eps):
    """Moller-Trumbore on ``[..., 3]`` operands: ``(hit, t, u, v)``."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = 1.0 / det
    tvx, tvy, tvz = (ox - v0[..., 0], oy - v0[..., 1], oz - v0[..., 2])
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = ((u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (det.abs() >= DET_TINY) & (t >= t_eps))
    return hit, t, u, v


def triangle_rows(positions: torch.Tensor, faces: torch.Tensor):
    """``(v0, e1, e2)`` ``[F, 3]`` of each face, in the positions' dtype."""
    v0 = positions[faces[:, 0]]
    return v0, positions[faces[:, 1]] - v0, positions[faces[:, 2]] - v0


# ---------------------------------------------------------------------------
# Candidate pairs by binning.
# ---------------------------------------------------------------------------


def _cell_range(lo_f, hi_f, cells: int):
    """Inclusive cell ranges of float boxes ``[lo_f, hi_f]`` in cell units,
    widened by one cell; ``(lo, hi, empty)``."""
    lo = torch.floor(lo_f.clamp(-4.0, cells + 4.0)).long() - 1
    hi = torch.floor(hi_f.clamp(-4.0, cells + 4.0)).long() + 1
    empty = (hi < 0) | (lo > cells - 1)
    return lo.clamp(0, cells - 1), hi.clamp(0, cells - 1), empty


def candidate_pairs(ray_cell, grid, lo, hi, empty):
    """Yield ``(ray, face)`` index chunks: each ray paired with every face
    whose inclusive cell box ``lo..hi`` ``[F, 2]`` (x, y) holds the ray's
    cell.  ``ray_cell`` ``[N, 2]`` int64 (x, y), -1 for a ray left out;
    ``grid`` ``(nx, ny)``; ``empty`` ``[F]`` drops a face.  At most about
    `CHUNK_TESTS` pairs a chunk (one face's pairs are never split)."""
    nx, ny = grid
    dev = ray_cell.device
    rid = (ray_cell[:, 0] >= 0).nonzero()[:, 0]
    cid = ray_cell[rid, 1] * nx + ray_cell[rid, 0]
    order = torch.argsort(cid, stable=True)
    rid, cid = rid[order], cid[order]
    count = torch.bincount(cid, minlength=nx * ny)
    start = torch.cumsum(count, 0) - count
    sat = torch.zeros((ny + 1, nx + 1), dtype=torch.int64, device=dev)
    sat[1:, 1:] = count.view(ny, nx).cumsum(0).cumsum(1)
    lx, ly, hx, hy = lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]
    tests = (sat[hy + 1, hx + 1] - sat[ly, hx + 1] - sat[hy + 1, lx]
             + sat[ly, lx])
    tests = torch.where(empty | (hx < lx) | (hy < ly), 0, tests)
    faces = (tests > 0).nonzero()[:, 0]
    if faces.numel() == 0:
        return
    cum = torch.cumsum(tests[faces], 0).cpu().numpy()
    cuts = np.searchsorted(cum, np.arange(CHUNK_TESTS, cum[-1], CHUNK_TESTS),
                           side="right")
    for fc in torch.tensor_split(faces, torch.as_tensor(cuts).tolist()):
        if fc.numel() == 0:
            continue
        w = hx[fc] - lx[fc] + 1
        ncell = w * (hy[fc] - ly[fc] + 1)
        pf = torch.repeat_interleave(torch.arange(fc.numel(), device=dev),
                                     ncell)
        k = torch.arange(pf.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(ncell, 0) - ncell, ncell)
        cell = (ly[fc][pf] + k // w[pf]) * nx + lx[fc][pf] + k % w[pf]
        n = count[cell]
        pair = torch.repeat_interleave(torch.arange(cell.numel(), device=dev),
                                       n)
        offs = torch.arange(pair.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(n, 0) - n, n)
        yield rid[start[cell][pair] + offs], fc[pf][pair]


def screen_boxes(positions, faces, eye, orient, width, height, zoom=1.0):
    """Each face's pixel box on the image of a pinhole camera: ``(lo, hi,
    empty)`` ``[F, 2]`` (column, row), widened by one pixel; a face with a
    vertex at or behind the eye's plane covers the whole image."""
    rel = positions - eye
    cam = [rel[:, 0] * orient[0, k] + rel[:, 1] * orient[1, k]
           + rel[:, 2] * orient[2, k] for k in range(3)]
    z = cam[2]
    front = z > 1e-6
    zs = torch.where(front, z, 1.0)
    px = (zoom * cam[0] / zs + 1.0) * (width / 2.0)
    py = (1.0 - zoom * cam[1] / zs) * (height / 2.0)
    pxf, pyf = px[faces], py[faces]
    lx, hx, ex = _cell_range(pxf.amin(1), pxf.amax(1), width)
    ly, hy, ey = _cell_range(pyf.amin(1), pyf.amax(1), height)
    behind = ~front[faces].all(1)
    lo = torch.stack([torch.where(behind, 0, lx), torch.where(behind, 0, ly)],
                     1)
    hi = torch.stack([torch.where(behind, width - 1, hx),
                      torch.where(behind, height - 1, hy)], 1)
    return lo, hi, (ex | ey) & ~behind


def _light_basis(light: torch.Tensor):
    """Two unit vectors across the unit ``light`` direction."""
    helper = torch.zeros_like(light)
    helper[int(torch.argmin(light.abs()))] = 1.0
    a = torch.linalg.cross(light, helper)
    a = a / torch.linalg.norm(a)
    return a, torch.linalg.cross(light, a)


# ---------------------------------------------------------------------------
# Closest and any hits.
# ---------------------------------------------------------------------------


def primary_hits(positions, faces, eye, orient, dirs, width, height, t_eps,
                 dtype, zoom=1.0):
    """Closest hit of the pixel rays ``dirs`` ``[H*W, 3]`` from ``eye``:
    ``(face [N] int64, -1 on a miss; t [N] float32, FLT_MAX on a
    miss)``."""
    dev = dirs.device
    n = width * height
    idx = torch.arange(n, device=dev)
    ray_cell = torch.stack([idx % width, idx // width], 1)
    lo, hi, empty = screen_boxes(positions, faces, eye, orient, width, height,
                                 zoom)
    v0, e1, e2 = triangle_rows(positions.to(dtype), faces)
    o, d = eye.to(dtype), dirs.to(dtype)
    key = torch.full((n,), _NO_KEY, dtype=torch.int64, device=dev)
    for r, f in candidate_pairs(ray_cell, (width, height), lo, hi, empty):
        hit, t, _, _ = mt(o, d[r], v0[f], e1[f], e2[f], t_eps)
        t = t[hit].to(torch.float32)
        k = (t.view(torch.int32).to(torch.int64) << 32) | f[hit]
        key.scatter_reduce_(0, r[hit], k, "amin")
    found = key != _NO_KEY
    face = torch.where(found, key & 0xFFFFFFFF, -1)
    t = torch.where(found, (key >> 32).to(torch.int32).view(torch.float32),
                    FLT_MAX)
    return face, t


def shadow_hits(positions, faces, origins, active, light, t_eps, dtype):
    """Any hit along the unit ``light`` from each active origin ``[N, 3]``:
    ``[N]`` bool, false where inactive."""
    dev = origins.device
    blocked = torch.zeros(active.shape, dtype=torch.bool, device=dev)
    idx = active.nonzero()[:, 0]
    if idx.numel() == 0:
        return blocked
    a, b = _light_basis(light.to(torch.float32))
    pa = origins[idx] @ a
    pb = origins[idx] @ b
    cells = int(np.clip(np.sqrt(idx.numel()), 1, 1024))
    lo_a, lo_b = pa.min(), pb.min()
    size_a = torch.clamp((pa.max() - lo_a) / cells, min=1e-12)
    size_b = torch.clamp((pb.max() - lo_b) / cells, min=1e-12)
    ray_cell = torch.full((origins.shape[0], 2), -1, dtype=torch.int64,
                          device=dev)
    ray_cell[idx, 0] = torch.floor((pa - lo_a) / size_a).long().clamp(
        0, cells - 1)
    ray_cell[idx, 1] = torch.floor((pb - lo_b) / size_b).long().clamp(
        0, cells - 1)
    va = ((positions @ a - lo_a) / size_a)[faces]
    vb = ((positions @ b - lo_b) / size_b)[faces]
    lx, hx, ex = _cell_range(va.amin(1), va.amax(1), cells)
    ly, hy, ey = _cell_range(vb.amin(1), vb.amax(1), cells)
    v0, e1, e2 = triangle_rows(positions.to(dtype), faces)
    o, d = origins.to(dtype), light.to(dtype)
    for r, f in candidate_pairs(ray_cell, (cells, cells),
                                torch.stack([lx, ly], 1),
                                torch.stack([hx, hy], 1), ex | ey):
        hit, _, _, _ = mt(o[r], d, v0[f], e1[f], e2[f], t_eps)
        blocked[r[hit]] = True
    return blocked & active


# ---------------------------------------------------------------------------
# Shading.
# ---------------------------------------------------------------------------


def unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp(torch.sum(v * v), min=1e-30))


def bilinear(textures, tex_id, u, v):
    """Bilinear fetch from ``[T, H, W, 3]`` textures, wrap addressing,
    the far texel clamped at the last row and column."""
    tcount, h, w = textures.shape[0], textures.shape[1], textures.shape[2]
    fu = torch.remainder(u, 1.0) * (w - 1)
    fv = torch.remainder(v, 1.0) * (h - 1)
    x0 = torch.floor(fu).long()
    y0 = torch.floor(fv).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    ax = (fu - x0)[:, None]
    ay = (fv - y0)[:, None]
    tid = tex_id.clamp(0, tcount - 1)
    top = textures[tid, y0, x0] * (1 - ax) + textures[tid, y0, x1] * ax
    bot = textures[tid, y1, x0] * (1 - ax) + textures[tid, y1, x1] * ax
    return top * (1 - ay) + bot * ay


class Surface(NamedTuple):
    corners: torch.Tensor  # [N, 3] vertex ids of the hit face
    weights: torch.Tensor  # [N, 3] barycentric weights (1 - u - v, u, v)
    ndotl: torch.Tensor  # [N] Lambert term, unshadowed
    normal: torch.Tensor  # [N, 3] interpolated unit normal, facing the ray


def surface(scene: RefScene, positions, face, hit, eye, d, light, dtype):
    """The hit point's barycentrics, worked out again from ``positions``
    (so that gradients reach them), and the Lambert term of its
    interpolated unit normal, turned to face the eye."""
    f = scene.faces[face.clamp(min=0)]
    v0 = positions[f[:, 0]]
    _, _, u, v = mt(eye, d, v0, positions[f[:, 1]] - v0,
                    positions[f[:, 2]] - v0, 0.0)
    u = torch.where(hit, u, 0.0)
    v = torch.where(hit, v, 0.0)
    wts = torch.stack([1.0 - (u + v), u, v], 1)
    nrm = scene.normals.to(dtype)
    n = (nrm[f[:, 0]] * wts[:, 0:1] + nrm[f[:, 1]] * wts[:, 1:2]
         + nrm[f[:, 2]] * wts[:, 2:3])
    n = n / torch.sqrt(torch.clamp((n * n).sum(1, keepdim=True), min=1e-30))
    n = torch.where(((n * d).sum(1) > 0.0)[:, None], -n, n)
    ndotl = torch.clamp((n * light.to(dtype)).sum(1), min=0.0)
    return Surface(f, wts, ndotl, n)


def colour(scene: RefScene, textures, s: Surface, face, hit, shadow,
           shading: Shading, dtype):
    """RGB ``[N, 3]``: albedo (times the texture where the face's
    material has one) lit by ambient plus unshadowed Lambert; the
    background where nothing was hit."""
    mat = scene.face_material[face.clamp(min=0)]
    albedo = scene.albedo.to(dtype)[mat]
    tid = scene.texture_id[mat]
    if bool((scene.texture_id >= 0).any()):
        uvs = scene.uvs.to(dtype)
        w = s.weights
        tuv = (uvs[s.corners[:, 0]] * w[:, 0:1] + uvs[s.corners[:, 1]]
               * w[:, 1:2] + uvs[s.corners[:, 2]] * w[:, 2:3])
        texel = bilinear(textures, tid, tuv[:, 0], tuv[:, 1])
        albedo = torch.where((tid >= 0)[:, None], albedo * texel, albedo)
    ndotl = torch.where(shadow, 0.0, s.ndotl)
    lit = (shading.ambient + (1.0 - shading.ambient) * ndotl)[:, None]
    bg = torch.tensor(shading.background, dtype=dtype, device=hit.device)
    return torch.where(hit[:, None], albedo * lit, bg)


def pack(rgb: torch.Tensor) -> torch.Tensor:
    """``[N, 3]`` colours in [0, 1] -> ``0x00RRGGBB`` int64."""
    c = torch.clamp(rgb.to(torch.float32) * 255.0, 0.0, 255.0).to(torch.int64)
    return (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]


def scene_extent(scene: RefScene) -> float:
    """The largest side of the scene's box."""
    return float((scene.positions.amax(0) - scene.positions.amin(0)).amax())


def render_frame(scene: RefScene, eye, orient, rays, width, height,
                 shading: Shading, shadows=True, dtype=torch.float32):
    """The packed frame ``[H*W]`` int64 of a viewer: shadow rays leave
    the hit points that face the light, pushed toward it by ``t_eps``
    times the scene's extent."""
    with torch.no_grad():
        d = rotate(rays, orient)
        face, t = primary_hits(scene.positions, scene.faces, eye, orient, d,
                               width, height, shading.t_eps, dtype)
        hit = face >= 0
        l = unit(torch.tensor(shading.light, dtype=torch.float32,
                              device=d.device))
        s = surface(scene, scene.positions.to(dtype), face, hit,
                    eye.to(dtype), d.to(dtype), l, dtype)
        shadow = torch.zeros_like(hit)
        if shadows:
            active = hit & (s.ndotl > 0.0)
            eps = torch.tensor(shading.t_eps * scene_extent(scene),
                               dtype=torch.float32, device=d.device)
            tmin = torch.clamp(t, max=1e6)[:, None]
            so = torch.where(active[:, None], eye + d * tmin, eye) + l * eps
            shadow = shadow_hits(scene.positions, scene.faces, so, active, l,
                                 shading.t_eps, dtype)
        return pack(colour(scene, scene.textures.to(dtype), s, face, hit,
                           shadow, shading, dtype))


def render_rgb(scene: RefScene, eye, orient, rays, width, height,
               shading: Shading, shadows=True, dtype=torch.float32):
    """The float image ``[H*W, 3]`` of inverse rendering, differentiable
    in ``scene.positions`` and ``scene.textures``: which face each ray
    hits, and which hit points are in shadow (rays from every hit point,
    pushed toward the light by 10 ``t_eps``), are held fixed; t, u and v
    are worked out again from the live positions."""
    with torch.no_grad():
        d = rotate(rays, orient)
        face, t = primary_hits(scene.positions.detach(), scene.faces, eye,
                               orient, d, width, height, shading.t_eps, dtype)
        hit = face >= 0
        l = unit(torch.tensor(shading.light, dtype=torch.float32,
                              device=d.device))
        shadow = torch.zeros_like(hit)
        if shadows:
            p = torch.where(hit[:, None],
                            eye + d * torch.clamp(t, max=1e6)[:, None], eye)
            shadow = shadow_hits(scene.positions.detach(), scene.faces,
                                 p + l * (10 * shading.t_eps), hit, l,
                                 shading.t_eps, dtype)
    s = surface(scene, scene.positions.to(dtype), face, hit, eye.to(dtype),
                d.to(dtype), l, dtype)
    return colour(scene, scene.textures.to(dtype), s, face, hit, shadow,
                  shading, dtype)


def progressive_image(scene: RefScene, eye, orient, width, height, passes,
                      shading: Shading, shadows=True, dtype=torch.float32):
    """The mean of ``passes`` images (`render_rgb`), pass k's rays through
    the pixels' Halton (2, 3) point number k."""
    accum = torch.zeros((width * height, 3), dtype=torch.float32,
                        device=eye.device)
    with torch.no_grad():
        for k in range(1, passes + 1):
            rays = camera_rays(width, height, (halton(k, 2), halton(k, 3)),
                               device=eye.device)
            accum = accum + render_rgb(scene, eye, orient, rays, width,
                                       height, shading, shadows,
                                       dtype).to(torch.float32)
    return accum / float(passes)
