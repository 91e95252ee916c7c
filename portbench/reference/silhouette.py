"""The reference of multi-view silhouette fitting: the gradient of an image
loss with respect to the vertex positions, interior and boundary parts,
and Adam steps on the positions, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
builds its own edge table from the faces and works the rest out from the
benchmark's inputs.

  * The interior part is autograd through `render.render_rgb` with no
    shadows: which face each pixel's ray hits is held fixed, t, u and v
    are worked out again from the live positions.
  * The boundary part is the edge-sampling estimator of Li, Aittala,
    Durand and Lehtinen, "Differentiable Monte Carlo Ray Tracing through
    Edge Sampling" (SIGGRAPH Asia 2018), with deterministic stratified
    samples: for the box-filtered pixel ``I_p``,

        dLoss/dtheta = sum_p g_p (1/A) int_{edges in p} (L_in - L_out)
                                                       (n . dx/dtheta) dl,

    ``g_p`` the loss's cotangent of pixel p, ``A`` a pixel's area on the
    screen, ``n`` the edge's screen normal pointing away from its visible
    face, ``L_in`` and ``L_out`` the radiance just inside and outside.
    An edge is a silhouette where its two faces differ in facing the eye,
    or where it has one face.  Each silhouette edge in front of the eye
    gets ``samples`` points at ``(k + 0.5) / samples`` of its length;
    a point in the frame is live.  Two probe rays leave the eye through
    the points ``x -+ delta n`` (``delta`` = ``offset_px`` of a pixel),
    traced and shaded as `render.py` traces and shades a pixel's ray (the
    probes leave the eye, so the screen bins of `render.screen_boxes`
    hold them: a probe is binned in its sample's pixel).  A sample counts
    only where the inside probe sees one of its edge's faces (else
    another surface hides the edge there).  The sum goes to the
    positions by autograd through the projection of the edge endpoints,
    the only differentiated function.

Departures from the program's rules, which reproduce the JAX package's
roundings as XLA compiles them on the CPU:

  * every rounding here is plain: a division by a constant is a division
    (the program multiplies by the constant's float32 reciprocal), and no
    product is fused into a sum (the program rounds the silhouette test,
    the normal's orientation, the sample points and the probes' offsets
    as fused multiply-adds).  A sample within an ulp of a pixel edge may
    then land in the other pixel, and a face whose facing is within an
    ulp of edge-on may be a silhouette on one side alone;
  * the pixel's column is ``floor((x + 1) W / 2)`` and its row
    ``floor((1 - y) H / 2)``;
  * the probes are traced by binning and every face's Moller-Trumbore
    test (`render.mt`), the program's by its clusters: a probe that
    grazes an edge between two faces may pick the other one;
  * the edge table keeps the first two faces of a non-manifold edge, in
    face order, as the program's does.

Every function takes the working ``dtype``: float32 for the reference,
bfloat16 for the control that must come out wrong.  The samples' pixels
and the probes' bins are worked out in float32 in both, as `render.py`
bins in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import render as ref
from .render import RefScene, Shading
from .train import AdamSettings


def edge_table(faces: torch.Tensor):
    """``(vertex ids [E, 2], adjacent faces [E, 2])`` int64 of the
    undirected edges of ``faces`` ``[F, 3]``, each edge's lower vertex id
    first; the second face is -1 on a boundary edge.  An edge of more
    than two faces keeps its first two, in face order."""
    f = faces[:, :3].long()
    nv = int(f.max()) + 1
    e = f[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)  # [3F, 2]
    owner = torch.arange(f.shape[0], device=f.device).repeat_interleave(3)
    key = e.amin(1) * nv + e.amax(1)
    order = torch.argsort(key, stable=True)
    key, owner = key[order], owner[order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    start = first.nonzero()[:, 0]
    count = torch.diff(start, append=torch.tensor([key.numel()],
                                                  device=f.device))
    adjacent = torch.full((start.numel(), 2), -1, dtype=torch.int64,
                          device=f.device)
    adjacent[:, 0] = owner[start]
    two = count >= 2
    adjacent[two, 1] = owner[start[two] + 1]
    k = key[start]
    return torch.stack([k // nv, k % nv], 1), adjacent


def project(points, eye, orient, zoom=1.0):
    """Screen points ``[N, 2]`` (the window ``[-1, 1]^2`` at distance
    ``zoom``, y up) and camera depth ``[N]`` of world ``points``: with
    ``q = orient^T (p - eye)``, ``(zoom q_x / q_z, zoom q_y / q_z)``."""
    q = (points - eye) @ orient
    z = q[:, 2]
    safe = torch.where(z.abs() < 1e-12, 1e-12, z)
    return torch.stack([zoom * q[:, 0] / safe, zoom * q[:, 1] / safe], 1), z


class Samples(NamedTuple):
    """The live samples of one view: flat ``[N]`` edge ``edge``, stratum
    ``k`` and pixel ``pix``; the edges' outward normals ``[E, 2]`` and
    screen lengths ``[E]``; the count of silhouette edges."""

    edge: torch.Tensor
    k: torch.Tensor
    pix: torch.Tensor
    x: torch.Tensor  # [N, 2] screen points
    normal: torch.Tensor
    length: torch.Tensor
    silhouettes: int


def edge_samples(positions, faces, edges, eye, orient, width, height,
                 samples, dtype, zoom=1.0) -> Samples:
    """The silhouette edges' live samples, in ``dtype`` (pixels in
    float32)."""
    vids, adjacent = edges
    f = faces[:, :3].long()
    p, e, o = positions.to(dtype), eye.to(dtype), orient.to(dtype)
    v0, v1, v2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
    fnorm = torch.linalg.cross(v1 - v0, v2 - v0)
    front = ((fnorm * ((v0 + v1 + v2) / 3.0 - e)).sum(1) < 0.0)
    has2 = adjacent[:, 1] >= 0
    ff = front[adjacent.clamp(min=0)] & (adjacent >= 0)
    silhouette = torch.where(has2, ff[:, 0] != ff[:, 1], True)
    visible = torch.where(has2 & ~ff[:, 0] & ff[:, 1], adjacent[:, 1],
                          adjacent[:, 0])

    a, za = project(p[vids[:, 0]], e, o, zoom)
    b, zb = project(p[vids[:, 1]], e, o, zoom)
    ev = b - a
    length = torch.sqrt(torch.clamp((ev * ev).sum(1), min=1e-30))
    t = ev / length[:, None]
    normal = torch.stack([t[:, 1], -t[:, 0]], 1)
    third = f[visible].sum(1) - vids[:, 0] - vids[:, 1]
    c, _ = project(p[third], e, o, zoom)
    inward = (normal * (c - (a + b) / 2.0)).sum(1) > 0.0
    normal = torch.where(inward[:, None], -normal, normal)

    cand = (silhouette & (za > 1e-6) & (zb > 1e-6)).nonzero()[:, 0]
    tau = (torch.arange(samples, dtype=torch.float32, device=p.device)
           + 0.5) / samples
    edge = cand.repeat_interleave(samples)
    k = torch.arange(samples, device=p.device).repeat(cand.numel())
    x = a[edge] + tau[k].to(dtype)[:, None] * ev[edge]
    xf = x.to(torch.float32)
    col = torch.floor((xf[:, 0] + 1.0) * (width / 2.0)).long()
    row = torch.floor((1.0 - xf[:, 1]) * (height / 2.0)).long()
    keep = (col >= 0) & (col < width) & (row >= 0) & (row < height)
    return Samples(edge=edge[keep], k=k[keep],
                   pix=(row * width + col)[keep], x=x[keep], normal=normal,
                   length=length, silhouettes=int(silhouette.sum()))


def probe_hits(scene: RefScene, eye, orient, dirs, pix, width, height,
               t_eps, dtype, zoom=1.0):
    """Closest hits of the rays ``dirs`` ``[N, 3]`` from ``eye``, ray i
    binned in pixel ``pix[i]``: ``(face [N], -1 on a miss)``, as
    `render.primary_hits` finds a pixel's (each candidate whose widened
    screen box holds the bin, Moller-Trumbore, the smallest t, ties to
    the smaller face id)."""
    n = dirs.shape[0]
    cells = torch.stack([pix % width, pix // width], 1)
    lo, hi, empty = ref.screen_boxes(scene.positions, scene.faces, eye,
                                     orient, width, height, zoom)
    v0, e1, e2 = ref.triangle_rows(scene.positions.to(dtype), scene.faces)
    o, d = eye.to(dtype), dirs.to(dtype)
    key = torch.full((n,), ref._NO_KEY, dtype=torch.int64, device=d.device)
    for r, f in ref.candidate_pairs(cells, (width, height), lo, hi, empty):
        hit, t, _, _ = ref.mt(o, d[r], v0[f], e1[f], e2[f], t_eps)
        t = t[hit].to(torch.float32)
        k = (t.view(torch.int32).to(torch.int64) << 32) | f[hit]
        key.scatter_reduce_(0, r[hit], k, "amin")
    return torch.where(key != ref._NO_KEY, key & 0xFFFFFFFF, -1)


def radiance(scene: RefScene, eye, dirs, face, shading: Shading, dtype):
    """Unshadowed Lambert radiance ``[N, 3]`` of the hits ``face`` of
    unit ``dirs`` from ``eye`` (`render.surface`, `render.colour`)."""
    hit = face >= 0
    light = ref.unit(torch.tensor(shading.light, dtype=torch.float32,
                                  device=dirs.device))
    s = ref.surface(scene, scene.positions.to(dtype), face, hit,
                    eye.to(dtype), dirs.to(dtype), light, dtype)
    return ref.colour(scene, scene.textures.to(dtype), s, face, hit,
                      torch.zeros_like(hit), shading, dtype)


class Boundary(NamedTuple):
    grad: torch.Tensor  # [V, 3] float32, the boundary part
    silhouettes: int  # silhouette edges
    live: int  # live samples (two probes each)
    counted: int  # of them, those whose edge owns the sample


def boundary_grad(scene: RefScene, edges, eye, orient, width, height,
                  g: torch.Tensor, shading: Shading, samples: int = 4,
                  offset_px: float = 0.05, dtype=torch.float32,
                  zoom: float = 1.0) -> Boundary:
    """The boundary part of the loss's gradient in the positions, for the
    image cotangent ``g`` ``[H*W, 3]`` (the loss's gradient in each pixel's
    colour)."""
    vids, adjacent = edges
    with torch.no_grad():
        s = edge_samples(scene.positions, scene.faces, edges, eye, orient,
                         width, height, samples, dtype, zoom)
        delta = offset_px * min(2.0 / width, 2.0 / height)
        n = s.normal[s.edge]
        inside, outside = s.x - delta * n, s.x + delta * n
        pts = torch.cat([inside, outside])
        cam = torch.cat([pts, torch.full_like(pts[:, :1], zoom)], 1)
        cam = cam / torch.sqrt((cam * cam).sum(1, keepdim=True))
        dirs = ref.rotate(cam, orient.to(dtype))
        pix = torch.cat([s.pix, s.pix])
        face = probe_hits(scene, eye, orient, dirs, pix, width, height,
                          shading.t_eps, dtype, zoom)
        light = radiance(scene, eye, dirs, face, shading, dtype)
        m = s.edge.numel()
        l_in, l_out = light[:m], light[m:]
        seen = face[:m]
        owns = (seen == adjacent[s.edge, 0]) | (
            (seen == adjacent[s.edge, 1]) & (adjacent[s.edge, 1] >= 0))
        c = (g.to(dtype)[s.pix] * (l_in - l_out)).sum(1)
        c = torch.where(owns, c, 0.0) * s.length[s.edge] / (
            samples * (2.0 / width) * (2.0 / height))
        tau = ((s.k.to(torch.float32) + 0.5) / samples).to(dtype)
        # dx/dtheta = (1 - tau) da/dtheta + tau db/dtheta, against c n.
        e_count = vids.shape[0]
        ca = torch.zeros((e_count, 2), dtype=dtype, device=g.device)
        cb = torch.zeros_like(ca)
        ca.index_add_(0, s.edge, (c * (1.0 - tau))[:, None] * n)
        cb.index_add_(0, s.edge, (c * tau)[:, None] * n)

    p = scene.positions.detach().to(dtype).requires_grad_()
    e, o = eye.to(dtype), orient.to(dtype)
    with torch.enable_grad():
        a, _ = project(p[vids[:, 0]], e, o, zoom)
        b, _ = project(p[vids[:, 1]], e, o, zoom)
        (grad,) = torch.autograd.grad(((a * ca).sum() + (b * cb).sum()), p)
    return Boundary(grad.to(torch.float32), s.silhouettes, m,
                    int(owns.sum()))


class StepGrad(NamedTuple):
    loss: float
    interior: torch.Tensor  # [V, 3] float32
    boundary: Boundary


def step_grad(scene: RefScene, edges, eye, orient, rays, width, height,
              target, shading: Shading, samples: int = 4,
              offset_px: float = 0.05, dtype=torch.float32) -> StepGrad:
    """The mean squared error of the unshadowed image against ``target``
    and its gradient in the positions, interior and boundary parts."""
    live = scene.positions.detach().clone().requires_grad_()
    img = ref.render_rgb(scene._replace(positions=live), eye, orient, rays,
                         width, height, shading, False, dtype)
    img = img.to(torch.float32)
    loss = torch.mean((img - target) ** 2)
    interior, g = torch.autograd.grad(loss, [live, img])
    b = boundary_grad(scene._replace(positions=live.detach()), edges, eye,
                      orient, width, height, g, shading, samples, offset_px,
                      dtype)
    return StepGrad(float(loss.detach()), interior, b)


class Steps(NamedTuple):
    losses: list  # float per step
    grad: torch.Tensor  # the first step's gradient of the positions
    change: torch.Tensor  # the positions' change over the steps
    boundary: list  # each step's `Boundary`


def adam_steps(scene: RefScene, edges, eyes, orients, rays, width, height,
               targets, shading: Shading, adam: AdamSettings, steps: int,
               samples: int = 4, offset_px: float = 0.05,
               dtype=torch.float32) -> Steps:
    """``steps`` Adam steps on the positions from the scene's own, step i
    on view ``i % len(eyes)`` against ``targets[i % len(eyes)]``, written
    out as `train.adam_steps` writes them."""
    start = scene.positions.detach().clone()
    x = start.clone()
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    losses, first, bounds = [], None, []
    for step in range(1, steps + 1):
        view = (step - 1) % len(eyes)
        r = step_grad(scene._replace(positions=x), edges, eyes[view],
                      orients[view], rays, width, height, targets[view],
                      shading, samples, offset_px, dtype)
        g = r.interior + r.boundary.grad
        losses.append(r.loss)
        bounds.append(r.boundary._replace(grad=None))
        if first is None:
            first = g.clone()
        with torch.no_grad():
            bc1 = 1.0 - adam.b1 ** step
            bc2 = 1.0 - adam.b2 ** step
            m.mul_(adam.b1).add_(g, alpha=1.0 - adam.b1)
            v.mul_(adam.b2).add_(g * g, alpha=1.0 - adam.b2)
            x.sub_(adam.lr / bc1 * m / (v.sqrt() / bc2 ** 0.5 + adam.eps))
    return Steps(losses, first, x - start, bounds)
