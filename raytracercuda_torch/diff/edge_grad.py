"""Silhouette (coverage) gradients by deterministic edge sampling
(counterpart of `raytracercuda_tpu/diff/edge_grad.py`).

`render_grad`'s fixed-id VJPs are exact for interior pixels only: a
pixel's coverage is a step function of the geometry, and the derivative
of the box-filtered pixel ``I_p = (1/A) \\int_p L(x) dx`` carries a
boundary term the fixed-id render does not model:

    dI_p/dtheta = (1/A) \\int_{edges \\cap p} (L_in - L_out)
                                             (n_hat . dx/dtheta) dl ,

``x`` the edge point on screen, ``n_hat`` the screen normal pointing away
from the occluding face, ``L_in`` / ``L_out`` the radiance just inside and
outside the edge.  `boundary_vjp` estimates the integral with K
stratified samples per silhouette edge; the radiances come from probe
rays offset ``+-delta`` along ``n_hat`` (values only), and the only
differentiated function is the projection of the edge endpoints:
`torch.autograd.grad` carries the term to the vertex positions, the eye
and the orientation in one pullback.

Every rule that decides a discrete result (which edges are silhouettes,
which way ``n_hat`` points, which pixel a sample reads, whether it is in
the frame, which edge owns it) is computed with the JAX package's
roundings as XLA compiles them on the CPU: a division by a constant is a
product with the constant's float32 reciprocal, and a product feeding a
sum is a fused multiply-add (`ops/math.fma32`, `dot_fused`), the same on
either device.  One rounding is not reproduced everywhere: XLA's dot in
`project_screen` rounds a few rows at the tail of an array otherwise
than the rest, so an endpoint there may differ from JAX's in its last
bit, which moves a decision only for a sample within that bit of a pixel
edge.

The probes leave the eye along their screen points' directions turned
into the world by the orientation (`_probe_world`, the forward rays'
`pipeline.rotate_rays`).  The JAX package traces the camera-space
directions themselves (`raytracercuda_tpu/diff/edge_grad.py:199-206`),
which is right for the identity orientation alone: under any other the
probes miss the edge and the term reads about 0.

The probes of samples that cannot count (not a silhouette, behind the
eye, off the frame) are not traced: JAX gives them an exact 0, and so
does the compaction here (`boundary_vjp(..., compact=False)` traces every
probe, for the test that holds the two routes equal).

The probes are traced in screen order (`_screen_order`): the samples
sorted by their pixels' Morton codes, each sample's two probes side by
side.  The general cull lists, for each group of 256 rays, every cluster
that its rays' cone can reach; in the edge table's order a group holds
samples from all around the outline and lists much of the scene, in
screen order a group covers a patch of about 128 neighbouring samples,
its cone is narrow and it lists fewer (the cone test still admits boxes
some way off a narrow cone's axis).  A probe's closest hit does not
depend on which rays share its group (the cull is conservative, ties go
to the lower cluster and slot), and every later step reads a sample by
its own row, so the order changes no bit of the term.

While program tracing is on (`utils/profiler.py`), `boundary_vjp` records
``boundary.samples`` (`edge_samples`), ``sync.live_samples`` (the
compaction's ``nonzero``, one host sync), ``boundary.probes`` (the
order, `probe_dirs` and the probes' trace and shade) and
``boundary.project`` (the endpoints' pullback), and counts the live
samples (``boundary_live_samples``, compacted route; two probe rays
each).  No constant is copied from the host per call: the probe offset
is a host scalar, the light and the background are the device's cached
copies (`render_grad._light_on`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.math import dot_fused, fma32
from ..utils.profiler import count, host_sync, span


# ---------------------------------------------------------------------------
# Static topology: undirected edge table with adjacent faces.
# ---------------------------------------------------------------------------


def build_edge_table(faces) -> tuple[np.ndarray, np.ndarray]:
    """``[E,2]`` vertex ids + ``[E,2]`` adjacent face ids (-1 = boundary).

    Host-side numpy; static per topology (vertex positions may change
    between steps, indices may not).  Non-manifold edges (more than two
    adjacent faces) keep their first two faces."""
    if isinstance(faces, torch.Tensor):
        faces = faces.cpu().numpy()
    F = np.asarray(faces)[:, :3]
    e = np.stack([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]], axis=1)
    e = e.reshape(-1, 2)  # [3F, 2], row i//3 = owning face
    owner = np.repeat(np.arange(F.shape[0], dtype=np.int32), 3)
    e_sorted = np.sort(e, axis=1)
    uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    E = uniq.shape[0]
    edge_faces = np.full((E, 2), -1, np.int32)
    order = np.argsort(inv, kind="stable")
    sinv = inv[order]
    first = np.searchsorted(sinv, np.arange(E), "left")
    last = np.searchsorted(sinv, np.arange(E), "right")
    edge_faces[:, 0] = owner[order[first]]
    has2 = (last - first) > 1
    edge_faces[has2, 1] = owner[order[np.minimum(first + 1,
                                                 len(order) - 1)]][has2]
    return uniq.astype(np.int32), edge_faces


# ---------------------------------------------------------------------------
# Screen projection (the only differentiated geometry path).
# ---------------------------------------------------------------------------


def _recip32(x: float) -> float:
    """The float32 reciprocal of a constant, as XLA folds ``y / x``."""
    return float(np.float32(1.0) / np.float32(x))


def project_screen(p: torch.Tensor, eye: torch.Tensor, orient: torch.Tensor,
                   zoom: float) -> tuple[torch.Tensor, torch.Tensor]:
    """World points ``[N,3]`` -> screen ``[N,2]`` (gx, gy) and camera depth
    ``[N]``: with ``q = orient^T (p - eye)``, ``gx = zoom q_x / q_z``, the
    inverse of `models/camera.camera_ray_grid`.  Differentiable; the
    matrix product rounds as XLA's dot on the CPU does at these shapes:
    the first two columns as plain sums in order, the depth with fused
    multiply-adds (`dot_fused`)."""
    d = p - eye[None, :]
    o = orient
    q0, q1 = ((d[:, 0] * o[0, j] + d[:, 1] * o[1, j]) + d[:, 2] * o[2, j]
              for j in range(2))
    z = dot_fused(d, o[:, 2])
    safe = torch.where(z.abs() < 1e-12, 1e-12, z)
    return torch.stack([zoom * q0 / safe, zoom * q1 / safe], dim=-1), z


def _cross_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.cross` as XLA on the CPU contracts it: ``fma(a1, b2, -a2 b1)``."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([fma32(a1, b2, -(a2 * b1)), fma32(a2, b0, -(a0 * b2)),
                        fma32(a0, b1, -(a1 * b0))], dim=-1)


def _dot2_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A sum over a trailing axis of 2 as XLA's reduce: fma(a1, b1, a0 b0)."""
    return fma32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0])


# ---------------------------------------------------------------------------
# The boundary cotangent.
# ---------------------------------------------------------------------------


class EdgeSamples(NamedTuple):
    """The discrete half of `boundary_vjp`, values only.  Per edge: the
    silhouette test, the screen length ``elen`` and the outward screen
    normal ``nhat`` ``[E, 2]``; per sample (``[E, K]``): the screen point
    ``x`` ``[E, K, 2]``, its pixel ``pix`` and ``live`` (silhouette, in
    front of the eye, in the frame); ``tau`` ``[K]``."""

    silhouette: torch.Tensor
    elen: torch.Tensor
    nhat: torch.Tensor
    tau: torch.Tensor
    x: torch.Tensor
    pix: torch.Tensor
    live: torch.Tensor


def edge_samples(positions, faces, edge_vids, edge_faces, eye, orient,
                 width: int, height: int, zoom: float,
                 num_samples: int) -> EdgeSamples:
    """Classify the edges and place K stratified samples on each
    (`edge_grad.py:141-195` of the JAX package, with its roundings)."""
    ev_ids = edge_vids.long()
    ef = edge_faces.long()
    f = faces[:, :3].long()
    v0, v1, v2 = positions[f[:, 0]], positions[f[:, 1]], positions[f[:, 2]]
    fnorm = _cross_fused(v1 - v0, v2 - v0)
    fcent = (v0 + v1 + v2) * _recip32(3.0)
    front = dot_fused(fnorm, fcent - eye[None, :]) < 0.0  # [F]
    ff = torch.where(ef >= 0, front[ef.clamp(min=0)], False)
    has2 = ef[:, 1] >= 0
    # The tracer is two-sided: a boundary edge is a silhouette whatever its
    # winding, an interior edge when its two faces differ in `front`.
    silhouette = torch.where(has2, ff[:, 0] != ff[:, 1], True)
    # The "in" side's face: the front-facing one where there are two.
    vis_face = torch.where(has2 & ~ff[:, 0] & ff[:, 1], ef[:, 1], ef[:, 0])

    a, za = project_screen(positions[ev_ids[:, 0]], eye, orient, zoom)
    b, zb = project_screen(positions[ev_ids[:, 1]], eye, orient, zoom)
    in_front = (za > 1e-6) & (zb > 1e-6)

    # Screen normal, pointing away from the visible face's third vertex.
    ev = b - a
    elen = torch.sqrt(torch.clamp(_dot2_fused(ev, ev), min=1e-30))
    ehat = ev / elen[:, None]
    nhat = torch.stack([ehat[:, 1], -ehat[:, 0]], dim=-1)
    fsum = f[vis_face, 0] + f[vis_face, 1] + f[vis_face, 2]
    third = fsum - ev_ids[:, 0] - ev_ids[:, 1]
    cproj, _ = project_screen(positions[third], eye, orient, zoom)
    inward = _dot2_fused(nhat, cproj - (a + b) * 0.5) > 0.0
    nhat = torch.where(inward[:, None], -nhat, nhat)

    tau = (torch.arange(num_samples, dtype=torch.float32,
                        device=positions.device) + 0.5) * _recip32(num_samples)
    x = fma32(tau[None, :, None], ev[:, None, :], a[:, None, :])  # [E,K,2]
    # Pixel j covers gx in [left + dx j, left + dx (j+1)).
    dx, dy = 2.0 / width, -2.0 / height
    px = torch.floor((x[..., 0] + 1.0) * _recip32(dx)).to(torch.int32)
    py = torch.floor((x[..., 1] - 1.0) * _recip32(dy)).to(torch.int32)
    in_frame = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pix = py.clamp(0, height - 1).long() * width + px.clamp(0, width - 1)
    live = (silhouette & in_front)[:, None] & in_frame
    return EdgeSamples(silhouette=silhouette, elen=elen, nhat=nhat, tau=tau,
                       x=x, pix=pix, live=live)


def probe_dirs(s: EdgeSamples, rows, delta: float,
               zoom: float) -> torch.Tensor:
    """Unit directions of the probes just inside and just outside the edge
    at the flat samples ``rows`` (``[E*K]`` indices): ``[2, N, 3]``.
    ``delta`` is rounded to float32 and enters the kernels as a host
    scalar (a 0-dim CPU tensor: no copy to the device)."""
    x = s.x.reshape(-1, 2)[rows]
    nhat = s.nhat[rows // s.tau.numel()]
    d = torch.tensor(delta, dtype=torch.float32)
    pr = torch.stack([fma32(-d, nhat, x), fma32(d, nhat, x)])  # [2,N,2]
    z = torch.full(pr.shape[:-1] + (1,), float(zoom), dtype=torch.float32,
                   device=x.device)
    p = torch.cat([pr, z], dim=-1)
    return p / torch.sqrt(dot_fused(p, p))[..., None]


def _spread_bits(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Bit i of each int64 in ``v`` (below ``2**bits``, ``bits <= 32``)
    moved to bit 2i, the others 0."""
    for shift, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                        (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                        (1, 0x5555555555555555)):
        if shift < bits:
            v = (v | (v << shift)) & mask
    return v


def _screen_order(rows: torch.Tensor, pix: torch.Tensor, width: int,
                  height: int) -> torch.Tensor:
    """The flat sample ids ``rows`` sorted by the Morton (Z-order) code of
    their pixels ``pix[rows]`` (``pix = py * width + px``), ties in their
    given order: the probes' trace groups consecutive rays, so neighbours
    on screen share a group.  On the rows' device, no host sync."""
    bits = (max(width, height) - 1).bit_length()
    p = pix[rows].long()
    xy = _spread_bits(torch.stack([p % width, p // width]), bits)
    _, perm = torch.sort(xy[0] | (xy[1] << 1), stable=True)
    return rows[perm]


def _probe_world(dirs: torch.Tensor, orient: torch.Tensor) -> torch.Tensor:
    """Camera-space probe directions ``[N, 3]`` in the world, as the
    forward render turns its rays (`pipeline.rotate_rays`).

    `portbench`'s silhouette cell looks for this name at set-up, to refuse
    at once a program that traces the probes in camera space: rename it
    there too."""
    from ..trace.pipeline import rotate_rays

    return rotate_rays(dirs, orient)


#: The probes' miss colour, the renders' default background.
_BACKGROUND = (0.0, 1.0, 0.0)


def _radiance(scene, accel, eye, dirs, config, shading, light_dir):
    """Radiance along unit ``dirs`` ``[N, 3]`` from ``eye``, and the hit
    faces, without gradients (JAX: `trace_hit`, `recompute_hit`, the
    shade).  The light and the background are the device's cached
    copies (`render_grad._light_on`)."""
    from ..trace.pipeline import trace_hit
    from ..trace.shade import shade_lambert_rgb, shade_normal_rgb
    from .render_grad import _light_on, recompute_hit

    orig = eye[None, :].expand(dirs.shape)
    hit = trace_hit(scene, accel, orig, dirs, config)
    h = recompute_hit(scene, hit.face, orig, dirs)
    bg = _light_on(_BACKGROUND, dirs.device, "sync.probe_background")
    if shading == "normal":
        rgb = shade_normal_rgb(scene, h, background=bg)
    else:
        rgb = shade_lambert_rgb(
            scene, h, orig, dirs,
            light_dir=_light_on(light_dir, dirs.device, "sync.shade_light"),
            background=bg)
    return rgb, hit.face


def boundary_vjp(g: torch.Tensor, scene, accel, edge_vids: torch.Tensor,
                 edge_faces: torch.Tensor, eye: torch.Tensor,
                 orient: torch.Tensor, config: RenderConfig, width: int,
                 height: int, zoom: float = 1.0, num_samples: int = 4,
                 offset_px: float = 0.05, shading: str = "lambert",
                 light_dir=(0.4, 0.8, -0.45), compact: bool = True):
    """Pull the image cotangent ``g [H*W, 3]`` back through the silhouette
    boundary integral -> ``(d_positions, d_eye, d_orient)``.

    The probes see detached values; gradients flow only through the
    screen projection of the edge endpoints.  ``compact`` traces only the
    probes of live samples (the others count 0 in either route).  The
    samples go in screen order (`_screen_order`), each one's two probes
    side by side, so that a group of the probes' trace covers a patch of
    the screen and its cull lists fewer clusters; the result is the same
    bits in any order."""
    from .render_grad import _detached_scene

    sg = _detached_scene(scene)
    pos, e, o = sg.positions, eye.detach(), orient.detach()
    dx, dy = 2.0 / width, -2.0 / height
    with torch.no_grad():
        with span("boundary.samples"):
            s = edge_samples(pos, sg.faces, edge_vids, edge_faces, e, o,
                             width, height, zoom, num_samples)
        E, K = s.live.shape
        live = s.live.reshape(-1)
        if compact:
            with host_sync("sync.live_samples"):
                rows = live.nonzero()[:, 0]
            count("boundary_live_samples", rows.numel())
        else:
            rows = torch.arange(E * K, device=live.device)
        n = rows.numel()
        with span("boundary.probes"):
            rows = _screen_order(rows, s.pix.reshape(-1), width, height)
            delta = offset_px * min(abs(dx), abs(dy))
            dirs = probe_dirs(s, rows, delta, zoom)
            if n:
                # [n, 2] probes: a sample's inside and outside ones adjacent.
                L, hf = _radiance(
                    sg, accel, e,
                    _probe_world(dirs.transpose(0, 1).reshape(-1, 3), o),
                    config, shading, light_dir)
                L = L.reshape(n, 2, 3).transpose(0, 1)
                hf = hf.reshape(n, 2).transpose(0, 1)
            else:  # no live sample: nothing to trace
                L = dirs.new_zeros((2, 0, 3))
                hf = torch.zeros((2, 0), dtype=torch.int32,
                                 device=dirs.device)
        # This edge owns the discontinuity only where the inside probe sees
        # one of its faces (else another surface hides the edge there).
        ef = edge_faces.long()[rows // K]
        owns = (hf[0] == ef[:, 0]) | ((hf[0] == ef[:, 1]) & (ef[:, 1] >= 0))
        c = torch.sum(g[s.pix.reshape(-1)[rows]] * (L[0] - L[1]), dim=-1)
        coeff = torch.zeros(E * K, dtype=torch.float32, device=live.device)
        coeff[rows] = torch.where(live[rows] & owns, c, 0.0)
        scale = s.elen * _recip32(K * abs(dx * dy))
        coeff = coeff.reshape(E, K) * scale[:, None]
        # dx/dtheta = (1 - tau) da/dtheta + tau db/dtheta, against coeff nhat.
        ca = torch.sum(coeff * (1.0 - s.tau)[None, :], dim=1)[:, None] * s.nhat
        cb = torch.sum(coeff * s.tau[None, :], dim=1)[:, None] * s.nhat

    leaves = [x.detach().requires_grad_() for x in (pos, e, o)]
    p, e_, o_ = leaves
    ids = edge_vids.long()
    with span("boundary.project"), torch.enable_grad():
        pa, _ = project_screen(p[ids[:, 0]], e_, o_, zoom)
        pb, _ = project_screen(p[ids[:, 1]], e_, o_, zoom)
        d_pos, d_eye, d_orient = torch.autograd.grad((pa, pb), leaves,
                                                     (ca, cb))
    return d_pos, d_eye, d_orient
