"""The plain reference of the public API's frame: what `Camera.trace_scene`
writes into a `RenderTarget` over a brute-force scene, with the
reference's normal shading (`BuildTree.cu:486-496`), in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
is given the benchmark's own inputs (the `RefScene` of `scenes.ref_scene`,
the camera's parameters, eye and orientation) and works out the rest.

  * The pinhole grid of ``set_initial_rays(width, height, left, right,
    top, bottom, zoom)``: pixel (i, j) looks through (x_j, y_i, zoom),
    x_j = left + (right - left) / width * (j + 0.5) and y_i = top +
    (bottom - top) / height * (i + 0.5), normalised, row-major from the
    row at ``top``.
  * Rays turned by ``orient`` (`render.rotate`), all from the eye.
  * The closest hit of every ray against every face, in blocks of rays:
    Moller-Trumbore (`render.mt`), a hit at t >= ``t_eps``, the smallest
    t, ties going to the lower face index (`render.primary_hits`' key).
  * The hit's vertex normal interpolated by its barycentrics and
    normalised (`render.surface`); red = trunc(|n.z| * 255) << 16 on a
    hit, ``MISS`` (255 << 8) on a miss.

Every function takes the working ``dtype``: float32 for the reference,
bfloat16 for the control that must come out wrong.
"""

from __future__ import annotations

import torch

from . import render

#: The packed colour of a miss, green.
MISS = 255 << 8
#: Ray-face pairs tested at once.
BLOCK_PAIRS = 1 << 23
_NO_KEY = torch.iinfo(torch.int64).max


def pinhole_rays(width: int, height: int, left: float, right: float,
                 top: float, bottom: float, zoom: float,
                 device=None) -> torch.Tensor:
    """Unit directions ``[H*W, 3]`` float32 in camera space."""
    f32 = torch.float32
    x = left + (right - left) / width * (
        torch.arange(width, dtype=f32, device=device) + 0.5)
    y = top + (bottom - top) / height * (
        torch.arange(height, dtype=f32, device=device) + 0.5)
    gx = x[None, :].expand(height, width)
    gy = y[:, None].expand(height, width)
    gz = torch.full_like(gx, zoom)
    d = 1.0 / torch.sqrt(zoom * zoom + gx * gx + gy * gy)
    return torch.stack([gx * d, gy * d, gz * d], -1).reshape(-1, 3)


def closest_faces(positions, faces, eye, dirs, t_eps,
                  dtype=torch.float32) -> torch.Tensor:
    """The face each ray from ``eye`` along ``dirs`` ``[N, 3]`` hits
    first, by testing every face: ``[N]`` int64, -1 on a miss."""
    v0, e1, e2 = (x[None] for x in render.triangle_rows(
        positions.to(dtype), faces))
    o, d = eye.to(dtype), dirs.to(dtype)
    n, nf = d.shape[0], faces.shape[0]
    ids = torch.arange(nf, device=d.device)
    key = torch.full((n,), _NO_KEY, dtype=torch.int64, device=d.device)
    step = max(1, BLOCK_PAIRS // max(nf, 1))
    for r0 in range(0, n, step):
        hit, t, _, _ = render.mt(o, d[r0:r0 + step, None], v0, e1, e2, t_eps)
        bits = t.to(torch.float32).view(torch.int32).to(torch.int64)
        key[r0:r0 + step] = torch.where(hit, (bits << 32) | ids,
                                        _NO_KEY).amin(1)
    return torch.where(key != _NO_KEY, key & 0xFFFFFFFF, -1)


def render_frame(scene: render.RefScene, eye, orient, rays, t_eps,
                 dtype=torch.float32) -> torch.Tensor:
    """The packed frame ``[H*W]`` int64 that `Camera.trace_scene` writes
    for the camera-space ``rays`` (`pinhole_rays`)."""
    with torch.no_grad():
        d = render.rotate(rays, orient)
        face = closest_faces(scene.positions, scene.faces, eye, d, t_eps,
                             dtype)
        hit = face >= 0
        s = render.surface(scene, scene.positions.to(dtype), face, hit,
                           eye.to(dtype), d.to(dtype),
                           torch.zeros(3, device=d.device), dtype)
        red = (s.normal[:, 2].abs() * 255.0).to(torch.int64) << 16
        return torch.where(hit, red, MISS)
