"""Differentiable rendering: pixel gradients to vertex positions, normals,
uvs, albedo, textures, eye and orientation (counterpart of
`raytracercuda_tpu/diff/render_grad.py:41-519, 630-643`).

Which face each ray hits is discrete, so the gradient is taken in two
parts:

  1. traversal (`pipeline.trace_hit`) and the shadow test
     (`pipeline.occlusion_hit`) run under ``torch.no_grad()`` on detached
     tensors; only the integer face ids and the shadow mask go on;
  2. t, u and v are re-derived from the hit face alone with live
     parameters, and shading interpolates, samples and lights them, so
     autograd reaches every continuous input.

The fast route, `_rows_recompute_shade`, gathers one attribute row per
ray; when the cluster set carries ``face_rank`` and the ray count is a
multiple of 256, it builds the row table in slot order and gathers
through `diff.scatter.gather_rows_tiled`, whose backward is kernel G.

These gradients are exact for interior pixels only: silhouette
(coverage) terms are not modelled.  `render_rgb_silhouette` renders the
same image and adds, when ``config.diff.silhouette`` is set, the
edge-sampling boundary term of `diff/edge_grad.py` to the gradients of
the positions, the eye and the orientation (the derivative of the
box-filtered image; JAX: `render_grad.py:525-627`).
"""

from __future__ import annotations

import torch

from ..config import AccelKind, RenderConfig
from ..models.mesh import VERTEX_DATA_NORMAL, VERTEX_DATA_UV1
from ..ops.interpolate import face_ray_intersect
from ..trace.pipeline import (occlusion_hit, rotate_rays, shadow_origins,
                              trace_hit)
from ..types import FLT_MAX, Hit
from ..utils import profiler
from ..utils.profiler import host_sync, span
from .scatter import check_frame_hw

#: Rays per tile of the gathers' backward (`diff/scatter.py`).
_SCATTER_B = 256


def _detached_scene(scene):
    return scene._replace(
        positions=scene.positions.detach(),
        attrs={k: v.detach() for k, v in scene.attrs.items()},
        albedo=scene.albedo.detach(), textures=scene.textures.detach())


#: Light directions copied to a device, by (float32 bits, device).
_LIGHTS: dict = {}
#: Most entries `_LIGHTS` holds; the oldest goes first.
_LIGHTS_KEPT = 64


def _light_on(light_dir, device: torch.device, site: str) -> torch.Tensor:
    """``light_dir`` as a float32 ``[3]`` tensor on ``device``.  A host
    sequence is copied once per (value, device) and the copy reused: a
    copy from host memory waits for the device's queue, so only the first
    waits, counted under ``site``.  The tensor is shared: read-only."""
    if isinstance(light_dir, torch.Tensor):
        return light_dir.to(device=device, dtype=torch.float32)
    host = torch.as_tensor(light_dir, dtype=torch.float32)
    # By bits, so that -0.0 and 0.0 stay apart.
    key = (tuple(host.view(torch.int32).tolist()), device)
    l = _LIGHTS.get(key)
    if l is None:
        if len(_LIGHTS) >= _LIGHTS_KEPT:
            del _LIGHTS[next(iter(_LIGHTS))]
        with host_sync(site):
            l = _LIGHTS[key] = host.to(device)
    return l


def hit_nondiff(scene, accel, origin, direction, config: RenderConfig,
                frame_hw=None, common_origin=None) -> Hit:
    """The traversal's `Hit`, computed without gradients on detached
    inputs (its ids and t are constants to autograd)."""
    with torch.no_grad():
        return trace_hit(
            _detached_scene(scene), accel, origin.detach(),
            direction.detach(), config, frame_hw=frame_hw,
            common_origin=None if common_origin is None
            else common_origin.detach())


def hit_ids_nondiff(scene, accel, origin, direction, config: RenderConfig,
                    frame_hw=None, common_origin=None) -> torch.Tensor:
    """Integer hit face ids, without gradients."""
    return hit_nondiff(scene, accel, origin, direction, config,
                       frame_hw=frame_hw, common_origin=common_origin).face


def recompute_hit(scene, face_ids, origin, direction) -> Hit:
    """Differentiable (t, u, v) for fixed face ids."""
    t, u, v = face_ray_intersect(scene.positions, scene.faces, face_ids,
                                 origin, direction)
    miss = face_ids < 0
    return Hit(t=torch.where(miss, float(FLT_MAX), t),
               u=torch.where(miss, 0.0, u), v=torch.where(miss, 0.0, v),
               face=face_ids)


def _rows_recompute_shade(scene, face_ids, eye, dirs, light_dir,
                          shadow_mask=None, ambient: float = 0.08,
                          background=(0.0, 1.0, 0.0), rays=None, orient=None,
                          accel=None, frame_hw=None):
    """Differentiable recompute + Lambert shade through one row gather.

    One per-face row table ``[F, 22(+6)]`` = v0|e1|e2|n0|n1|n2|albedo|tex
    (|uv0|uv1|uv2) is built from the live parameters, one row is gathered
    per ray, and the per-ray math runs on ``[N]`` columns, term for term
    as `ops/math.tri_intersect` and the generic Lambert route.  Texturing
    gathers one ``[N, 12]`` row of the 2x2 bilinear footprint per ray.

    ``eye`` is the common origin of all rays.  With ``rays`` and
    ``orient`` the directions are ``rays @ orient.T`` (gradients reach
    ``orient``); otherwise ``dirs [N, 3]``.  With ``accel.face_rank`` and
    a ray count that 256 divides, the table is in slot order and both
    gathers go through `gather_rows_tiled` (kernel G in the backward).
    Returns ``(rgb [N, 3], t [N], hit [N])``."""
    from .scatter import gather_rows_tiled

    f = scene.faces
    num_rays = face_ids.shape[0]
    use_tiled = (accel is not None
                 and getattr(accel, "face_rank", None) is not None
                 and num_rays % _SCATTER_B == 0)
    if use_tiled:
        # Slot-ordered face table: pixel tiles hit Morton-contiguous slots.
        f = f[accel.face_order[:f.shape[0]].clamp(min=0)]
        ids = accel.face_rank[face_ids.clamp(min=0).long()]
        ids = torch.where(face_ids < 0, -1, ids)
        tile_shape = (num_rays // _SCATTER_B, _SCATTER_B)
    else:
        ids = face_ids
    pos = scene.positions
    v0 = pos[f[:, 0]]
    e1 = pos[f[:, 1]] - v0
    e2 = pos[f[:, 2]] - v0
    n = scene.attrs[VERTEX_DATA_NORMAL]
    mat = scene.mesh_material[f[:, 3]]
    cols = [v0, e1, e2, n[f[:, 0]], n[f[:, 1]], n[f[:, 2]],
            scene.albedo[mat],
            scene.texture_id[mat].to(torch.float32)[:, None]]
    has_uv = VERTEX_DATA_UV1 in scene.attrs and scene.textures.shape[0] > 0
    if has_uv:
        uv = scene.attrs[VERTEX_DATA_UV1]
        cols += [uv[f[:, 0], :2], uv[f[:, 1], :2], uv[f[:, 2], :2]]
    rows = torch.cat(cols, dim=1)  # [F, 22(+6)]

    if use_tiled:
        r = gather_rows_tiled(rows, ids, tile_shape, frame_hw=frame_hw)
    else:
        r = rows[ids.clamp(min=0).long()]  # the one per-ray gather
    c = r.T  # [D, N]: one column per attribute
    if rays is not None and orient is not None:
        # dirs = rays @ orient.T, per component and planar (`rotate_rays`).
        rt = rays.T
        d3 = (orient[:, 0:1] * rt[0] + orient[:, 1:2] * rt[1]
              + orient[:, 2:3] * rt[2])
        dx, dy, dz = d3[0], d3[1], d3[2]
    else:
        dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    ox, oy, oz = eye[0], eye[1], eye[2]
    # Möller–Trumbore on columns (`ops/math.tri_intersect` term order).
    e1x, e1y, e1z, e2x, e2y, e2z = c[3], c[4], c[5], c[6], c[7], c[8]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    # An exactly-zero det (a ray in the triangle's plane) must be guarded
    # in the denominator itself: the backward multiplies d(1/det) = -inf
    # by the masked branch's zero cotangent, and 0 * inf is NaN.  Forcing
    # det to 1 there and the ray to a miss keeps the forward's values.
    degenerate = det == 0.0
    inv = 1.0 / torch.where(degenerate, 1.0, det)
    tvx, tvy, tvz = ox - c[0], oy - c[1], oz - c[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    miss = ((face_ids < 0) | degenerate | torch.isnan(u) | torch.isnan(v)
            | torch.isnan(t))
    miss = miss | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    t = torch.where(miss, float(FLT_MAX), t)
    u = torch.where(face_ids < 0, 0.0, u)
    v = torch.where(face_ids < 0, 0.0, v)
    # The traversal's verdict decides a hit, not the recompute's range
    # test: ids of a stale cluster set may extrapolate slightly outside
    # their triangle after the parameters move, and shading them keeps
    # gradients alive there.
    hitm = face_ids >= 0

    # Interpolated normal facing the eye, then Lambert.
    w = 1.0 - (u + v)
    nx = c[9] * w + c[12] * u + c[15] * v
    ny = c[10] * w + c[13] * u + c[16] * v
    nz = c[11] * w + c[14] * u + c[17] * v
    nlen = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-30))
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen
    flip = nx * dx + ny * dy + nz * dz > 0.0
    nx = torch.where(flip, -nx, nx)
    ny = torch.where(flip, -ny, ny)
    nz = torch.where(flip, -nz, nz)
    l = _light_on(light_dir, dx.device, "sync.shade_light")
    l = l / torch.sqrt(torch.clamp(torch.sum(l * l), min=1e-30))
    ndotl = torch.clamp(nx * l[0] + ny * l[1] + nz * l[2], min=0.0)
    if shadow_mask is not None:
        ndotl = torch.where(shadow_mask, 0.0, ndotl)
    ar, ag, ab = c[18], c[19], c[20]
    if has_uv:
        # Bilinear fetch as one [N, 12] row gather: each texel's 2x2
        # footprint, edge-clamped like `sample_texture`'s min(x0+1, w-1).
        tex = scene.textures
        tcount, th, tw = tex.shape[0], tex.shape[1], tex.shape[2]
        sx = torch.cat([tex[:, :, 1:], tex[:, :, -1:]], dim=2)
        sy = torch.cat([tex[:, 1:], tex[:, -1:]], dim=1)
        sxy = torch.cat([sx[:, 1:], sx[:, -1:]], dim=1)
        quad = torch.cat([tex, sx, sy, sxy], dim=-1)  # [T, H, W, 12]
        flat = quad.reshape(tcount * th * tw, 12)

        tex_id = c[21].to(torch.int32)
        tu = c[22] * w + c[24] * u + c[26] * v
        tv = c[23] * w + c[25] * u + c[27] * v
        # torch.remainder, like jnp's %, takes the sign of the divisor.
        fu = torch.remainder(tu, 1.0) * (tw - 1)
        fv = torch.remainder(tv, 1.0) * (th - 1)
        x0 = torch.floor(fu).to(torch.int32)
        y0 = torch.floor(fv).to(torch.int32)
        ax = fu - x0
        ay = fv - y0
        tid = torch.clamp(tex_id, 0, tcount - 1)
        qidx = (tid * th + y0) * tw + x0
        texd = tex_id >= 0
        if use_tiled:
            # Texel ids are uv-coherent per pixel tile: the same backward.
            # Only textured hits pass the texture a cotangent; the other
            # rays would add zeros, every miss to one texel (kernel G's
            # atomics would queue on it), so they gather as misses.
            qidx = torch.where(hitm & texd, qidx, -1)
            q = gather_rows_tiled(flat, qidx, tile_shape,
                                  frame_hw=frame_hw).T
        else:
            q = flat[qidx.long()].T  # [12, N]
        chans = []
        for ch, albedo_ch in enumerate((ar, ag, ab)):
            top = q[ch] * (1 - ax) + q[3 + ch] * ax
            bot = q[6 + ch] * (1 - ax) + q[9 + ch] * ax
            chans.append(torch.where(texd, albedo_ch * (top * (1 - ay)
                                                        + bot * ay),
                                     albedo_ch))
        ar, ag, ab = chans
    lit = ambient + (1.0 - ambient) * ndotl
    bg = background
    out = torch.stack([torch.where(hitm, ar * lit, bg[0]),
                       torch.where(hitm, ag * lit, bg[1]),
                       torch.where(hitm, ab * lit, bg[2])], dim=-1)
    return out, t, hitm


def _occlusion_from_hit(scene, accel, hit_nd: Hit, origin, dirs, config,
                        light_dir, frame_hw) -> torch.Tensor:
    """Discrete directional-light occlusion mask from a traversal `Hit`,
    through `pipeline.occlusion_hit` (none on GRID, as in the JAX
    package); `_discrete` calls it without gradients on detached rays.

    The shadow rule is the gradient route's own, not `FrameRenderer`'s:
    origins ``hit point + l * (10 * t_epsilon)`` toward the unit light
    (no scene-extent scaling), active wherever the primary ray hit."""
    if config.accel == AccelKind.GRID and accel is not None:
        # The JAX package hands a hash grid to the LBVH's any-hit walk
        # (raytracercuda_tpu/diff/render_grad.py:408-416), which fails on
        # it; the port keeps that behaviour rather than add shadows there.
        raise NotImplementedError(
            "render_rgb has no shadows on a GRID structure: the JAX "
            "package's _occlusion_from_hit sends it to any_hit_bvh "
            "(raytracercuda_tpu/diff/render_grad.py:408-416), which fails")
    l = _light_on(light_dir, dirs.device, "sync.occlusion_light")
    l = l / torch.sqrt(torch.sum(l * l))
    hit_mask = hit_nd.hit_mask  # a property: one launch each read
    so = shadow_origins(origin, dirs, hit_nd.t, hit_mask, l,
                        10 * config.trace.t_epsilon, 1e6)
    return occlusion_hit(_detached_scene(scene), accel, so, l, hit_mask,
                         config, frame_hw)


def _discrete(scene, accel, initial_rays, eye, orient, config, shading,
              with_shadows, light_dir, frame_hw):
    """The render's combinatorics: hit face ids and (with shadows and
    Lambert shading) the shadow mask, both constants to autograd (span
    ``render.discrete``)."""
    check_frame_hw(frame_hw, initial_rays.shape[0])
    with span("render.discrete"), torch.no_grad():
        dirs = rotate_rays(initial_rays.detach(), orient.detach())
        e = eye.detach()
        origin = e[None, :].expand(dirs.shape)
        hit_nd = hit_nondiff(scene, accel, origin, dirs, config,
                             frame_hw=frame_hw, common_origin=e)
        shadow_mask = None
        if with_shadows and shading != "normal":
            shadow_mask = _occlusion_from_hit(scene, accel, hit_nd, origin,
                                              dirs, config, light_dir,
                                              frame_hw)
    return hit_nd.face, shadow_mask


def _render_fixed_ids(scene, initial_rays, eye, orient, face_ids,
                      shadow_mask, config, shading, light_dir, accel=None,
                      frame_hw=None):
    """The differentiable part of the render, for fixed combinatorics."""
    from ..trace.shade import shade_lambert_rgb, shade_normal_rgb

    del config  # the JAX signature's; the fixed-id render needs none
    dirs = rotate_rays(initial_rays, orient)
    origin = eye[None, :].expand(dirs.shape)
    if shading == "normal":
        hit = recompute_hit(scene, face_ids, origin, dirs)
        return shade_normal_rgb(scene, hit, background=(0.0, 1.0, 0.0))
    if VERTEX_DATA_NORMAL in scene.attrs:
        rgb, _, _ = _rows_recompute_shade(scene, face_ids, eye, dirs,
                                          light_dir, shadow_mask,
                                          rays=initial_rays, orient=orient,
                                          accel=accel, frame_hw=frame_hw)
        return rgb
    hit = recompute_hit(scene, face_ids, origin, dirs)
    return shade_lambert_rgb(scene, hit, origin, dirs, light_dir=light_dir,
                             shadow_mask=shadow_mask)


def render_rgb(scene, accel, initial_rays: torch.Tensor, eye: torch.Tensor,
               orient: torch.Tensor, config: RenderConfig,
               shading: str = "lambert", with_shadows: bool = False,
               light_dir=(0.4, 0.8, -0.45), frame_hw=None) -> torch.Tensor:
    """Differentiable forward render -> float RGB ``[N, 3]``.

    Differentiable in ``scene.positions``, ``scene.attrs`` (normals,
    uvs), ``scene.albedo``, ``scene.textures``, ``initial_rays``, ``eye``
    and ``orient``: any of them that requires grad gets one from
    ``backward()``.  ``frame_hw`` ``(H, W)``, when given, must cover the
    rays; without it the rays trace as a bundle.

    Span ``render`` holds ``render.discrete`` and ``render.shade``; while
    tracing is on, the backward of ``render.shade``'s graph is span
    ``grad`` (`_GradMark`)."""
    with span("render"):
        face_ids, shadow_mask = _discrete(scene, accel, initial_rays, eye,
                                          orient, config, shading,
                                          with_shadows, light_dir, frame_hw)
        held = None
        if profiler.enabled and torch.is_grad_enabled():
            held = []
            leaves = _GradMark.mark(held, False, [
                *_scene_leaves(scene), initial_rays, eye, orient])
            scene = _with_leaves(scene, leaves[:-3])
            initial_rays, eye, orient = leaves[-3:]
        with span("render.shade"):
            rgb = _render_fixed_ids(scene, initial_rays, eye, orient,
                                    face_ids, shadow_mask, config, shading,
                                    light_dir, accel=accel,
                                    frame_hw=frame_hw)
        if held is not None:
            (rgb,) = _GradMark.mark(held, True, [rgb])
        return rgb


class _GradMark(torch.autograd.Function):
    """Identity on the tensors that require grad, to record the backward
    of the graph between two marks as span ``grad``: the mark on the
    graph's output (``opening``) opens the span when the backward reaches
    it, the mark on its inputs closes it once every input's gradient is
    in.  Spans open in ``held``.  Gradients pass unchanged."""

    @staticmethod
    def forward(ctx, held, opening, *xs):
        ctx.held, ctx.opening = held, opening
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        if ctx.opening:
            ctx.held.append(span("grad").open())
        else:
            while ctx.held:
                ctx.held.pop().close()
        return (None, None, *grads)

    @staticmethod
    def mark(held, opening, xs):
        """``xs`` with those that require grad passed through the mark."""
        need = [i for i, x in enumerate(xs) if x.requires_grad]
        out = list(xs)
        if need:
            marked = _GradMark.apply(held, opening, *(xs[i] for i in need))
            for i, y in zip(need, marked):
                out[i] = y
        return out


class _RenderVJP(torch.autograd.Function):
    """`render_rgb` whose backward differentiates only the fixed-id render:
    it never sees the clusters or the traversal.  ``opts`` is ``(accel,
    config, shading, with_shadows, light_dir, frame_hw)``, and for
    `render_rgb_silhouette` also ``(edge_vids, edge_faces, width, height,
    zoom)``: the backward then adds the boundary term."""

    @staticmethod
    def forward(ctx, opts, scene, *leaves):
        accel, config, shading, with_shadows, light_dir, frame_hw = opts[:6]
        initial_rays, eye, orient = leaves[-3:]
        with span("render"):
            face_ids, shadow_mask = _discrete(scene, accel, initial_rays,
                                              eye, orient, config, shading,
                                              with_shadows, light_dir,
                                              frame_hw)
            ctx.opts, ctx.scene = opts, scene
            ctx.face_ids, ctx.shadow_mask = face_ids, shadow_mask
            ctx.save_for_backward(*leaves)
            with span("render.shade"):
                return _render_fixed_ids(scene, initial_rays, eye, orient,
                                         face_ids, shadow_mask, config,
                                         shading, light_dir, accel=accel,
                                         frame_hw=frame_hw)

    @staticmethod
    def backward(ctx, g):
        with span("grad"):
            return _RenderVJP._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        """The backward's body: the fixed-id render recomputed under
        ``enable_grad`` (span ``grad.recompute``), its VJP by
        `torch.autograd.grad` (``grad.autograd``), and the boundary
        term (``grad.boundary``, `edge_grad.boundary_vjp`)."""
        accel, config, shading, _, light_dir, frame_hw = ctx.opts[:6]
        leaves = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[2:])]
        scene = _with_leaves(ctx.scene, leaves[:-3])
        with torch.enable_grad():
            with span("grad.recompute"):
                out = _render_fixed_ids(scene, *leaves[-3:], ctx.face_ids,
                                        ctx.shadow_mask, config, shading,
                                        light_dir, accel=accel,
                                        frame_hw=frame_hw)
            wanted = [x for x in leaves if x.requires_grad]
            with span("grad.autograd"):
                grads = iter(torch.autograd.grad(out, wanted, g,
                                                 allow_unused=True))
        grads = [next(grads) if x.requires_grad else None for x in leaves]
        edges = ctx.opts[6] if len(ctx.opts) > 6 else None
        if (edges is not None and config.diff.silhouette
                and any(leaves[i].requires_grad for i in (0, -2, -1))):
            # The boundary term reaches the positions, the eye and the
            # orientation (leaves 0, -2 and -1).
            from .edge_grad import boundary_vjp

            edge_vids, edge_faces, width, height, zoom = edges
            with span("grad.boundary"):
                terms = boundary_vjp(
                    g, scene, accel, edge_vids, edge_faces, leaves[-2],
                    leaves[-1], config, width, height, zoom=zoom,
                    num_samples=config.diff.edge_samples,
                    offset_px=config.diff.edge_offset_px, shading=shading,
                    light_dir=light_dir)
            for i, term in zip((0, -2, -1), terms):
                if leaves[i].requires_grad:
                    grads[i] = term if grads[i] is None else grads[i] + term
        return (None, None, *grads)


def _scene_leaves(scene) -> list:
    """The scene's differentiable tensors in a fixed order: positions, the
    vertex attributes by slot, albedo, textures."""
    return [scene.positions, *(scene.attrs[k] for k in sorted(scene.attrs)),
            scene.albedo, scene.textures]


def _with_leaves(scene, leaves):
    keys = sorted(scene.attrs)
    return scene._replace(
        positions=leaves[0],
        attrs=dict(zip(keys, leaves[1:1 + len(keys)])),
        albedo=leaves[1 + len(keys)], textures=leaves[2 + len(keys)])


def render_rgb_vjp(scene, accel, initial_rays, eye, orient,
                   config: RenderConfig, shading: str = "lambert",
                   with_shadows: bool = False, light_dir=(0.4, 0.8, -0.45),
                   frame_hw=None) -> torch.Tensor:
    """`render_rgb` with the stop-grad/recompute structure made explicit
    as a `torch.autograd.Function`: the same forward, and a backward that
    re-runs only `_render_fixed_ids` on the forward's ids and shadow
    mask."""
    opts = (accel, config, shading, with_shadows, tuple(light_dir),
            None if frame_hw is None else tuple(frame_hw))
    return _RenderVJP.apply(opts, scene, *_scene_leaves(scene), initial_rays,
                            eye, orient)


def render_rgb_silhouette(scene, accel, eye, orient, config: RenderConfig,
                          width: int, height: int, zoom: float = 1.0,
                          shading: str = "lambert",
                          light_dir=(0.4, 0.8, -0.45),
                          edge_table=None) -> torch.Tensor:
    """Pinhole render ``[H*W, 3]`` whose backward pass includes the
    silhouette (coverage) boundary term.

    The forward pass is `render_rgb(..., frame_hw=(height, width))`
    without shadows on `camera_ray_grid`'s rays, bit for bit; the
    backward is `render_rgb_vjp`'s fixed-id VJP plus, when
    ``config.diff.silhouette`` is set, `edge_grad.boundary_vjp`'s terms
    for the positions, the eye and the orientation.  ``edge_table`` is
    `build_edge_table(faces)`, built on the host when None.  A job that
    renders one topology many times builds it once and passes it as two
    int32 tensors on the scene's device, ``(edge_vids [E, 2], edge_faces
    [E, 2])``: that form is used as it is, with no copy; a host table is
    copied to the device on every call (a blocking copy of ``16 E``
    bytes).  The boundary probes ignore shadows; shadow-boundary
    gradients are not modelled."""
    from ..models.camera import camera_ray_grid
    from .edge_grad import build_edge_table

    dev = scene.positions.device
    if edge_table is None:
        edge_table = build_edge_table(scene.faces)
    edge_vids, edge_faces = (torch.as_tensor(t, dtype=torch.int32,
                                             device=dev) for t in edge_table)
    rays = camera_ray_grid(width, height, zoom=zoom, device=dev)
    opts = (accel, config, shading, False, tuple(light_dir), (height, width),
            (edge_vids, edge_faces, width, height, zoom))
    return _RenderVJP.apply(opts, scene, *_scene_leaves(scene), rays, eye,
                            orient)


def l2_image_loss(scene, accel, initial_rays, eye, orient, target,
                  config: RenderConfig, **render_kw) -> torch.Tensor:
    """Mean squared pixel loss of `render_rgb` against ``target``."""
    img = render_rgb(scene, accel, initial_rays, eye, orient, config,
                     **render_kw)
    return torch.mean((img - target) ** 2)
