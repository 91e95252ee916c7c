"""General-ray tile sweeps and the multi-bounce frame on the kernels
(counterpart of `raytracercuda_tpu/trace/pallas_bounce.py`).

  * `general_tile_cull` replaces the pinhole frustum for tile-coherent
    bundles of arbitrary rays: per-axis reachability from the tile's
    origin box along its direction box, and a bounding cone around the
    mean direction.  Both tests are conservative.  One launch of
    `csrc/cull.cu`'s `general_cull_kernel` for CUDA tensors
    (`_general_cull_cuda`, counted as ``launch_counts["general_cull"]``),
    the plain chain `_general_cull_plain` for CPU tensors.
  * `trace_shade_general_planar` culls and runs kernel F
    (`sweep._general_shade_cuda`, or its plain version on the CPU): kernel
    A's closest hit and attributes from per-ray origins, with an activity
    mask.
  * `trace_rays` traces a ray bundle that is not a pinhole frame (JAX:
    `dense.trace_clusters_rays`): groups of rays in their given order,
    the general cull, and C's t/u/v/slot epilogue over F's sweep
    (`sweep._closest_rays_cuda`).
  * `render_bounces_tiled` (JAX: `render_bounces_pallas`) renders the whole
    multi-bounce frame planar: the primary pass through kernel A, shadows
    through kernel B, then one launch of F per bounce, with the
    energy-conserving blend of `trace/bounce.py`.  ``sort_bounces`` re-bins
    each bounce's rays by origin Morton code and direction bucket
    (`_coherence_perm`); it was measured as a loss on the TPU and is off by
    default.
"""

from __future__ import annotations

import torch

from ..config import TraceConfig
from ..ops.cuda_build import kernel_fn, raw_stream
from ..ops.math import normalize
from ..types import FLT_MAX, Hit
from ..utils.profiler import count, host_copies, span
from .dense import tile_pixels_planar, untile_pixels
from .shade import faced_ndotl_planar, lambert_planar, shadow_origins_planar
from .sweep import (
    _check_boxes,
    _check_cuda,
    _closest_rays_cuda,
    _closest_rays_plain,
    _general_shade_cuda,
    _general_shade_plain,
    _pick,
    _tile_lists,
    launch_counts,
    occlusion_tiles_planar,
    segment_blocks,
    t_eps_of,
    trace_shade_tiles_planar,
)

_BIG = 3.0e37


def _general_cull_plain(o3_tiles, d3_tiles, a_tiles, cmin, cmax):
    """Plain version of the general-cull kernel: the ``[T, C]`` bool
    survive mask of `general_tile_cull`.  The op order is
    `pallas_bounce.general_tile_cull`'s, with the axes accumulated one at a
    time so no ``[T, C, 3]`` tensor exists."""
    act = a_tiles[:, None, :]  # [T,1,R]
    omin = torch.where(act, o3_tiles, _BIG).amin(dim=2)  # [T,3]
    omax = torch.where(act, o3_tiles, -_BIG).amax(dim=2)
    dmin = torch.where(act, d3_tiles, _BIG).amin(dim=2)
    dmax = torch.where(act, d3_tiles, -_BIG).amax(dim=2)
    any_act = a_tiles.any(dim=1)  # [T]

    # Mean direction and the cone's cosine over active rays (unit
    # directions).
    dsum = torch.where(act, d3_tiles, 0.0).sum(dim=2)  # [T,3]
    dlen = torch.sqrt(torch.clamp(dsum[:, 0] * dsum[:, 0]
                                  + dsum[:, 1] * dsum[:, 1]
                                  + dsum[:, 2] * dsum[:, 2], min=1e-30))
    m = dsum / dlen[:, None]
    cosr = (d3_tiles[:, 0] * m[:, 0:1] + d3_tiles[:, 1] * m[:, 1:2]
            + d3_tiles[:, 2] * m[:, 2:3])  # [T,R]
    cos_min = torch.where(a_tiles, cosr, 1.0).amin(dim=1)  # [T]

    ok = any_act[:, None].expand(a_tiles.shape[0], cmin.shape[0])
    sup = torch.zeros(ok.shape, dtype=torch.float32, device=ok.device)
    gap2 = torch.zeros_like(sup)
    for i in range(3):
        reach_lo = torch.where(dmin[:, i] >= 0.0, omin[:, i], -_BIG)[:, None]
        reach_hi = torch.where(dmax[:, i] <= 0.0, omax[:, i], _BIG)[:, None]
        ok = ok & (cmax[None, :, i] >= reach_lo) & (cmin[None, :, i]
                                                    <= reach_hi)
        wlo = cmin[None, :, i] - omax[:, i, None]  # [T,C]
        whi = cmax[None, :, i] - omin[:, i, None]
        mi = m[:, i, None]
        sup = sup + torch.maximum(mi * wlo, mi * whi)
        g = torch.clamp(torch.maximum(wlo, -whi), min=0.0)
        gap2 = gap2 + g * g
    # The cone constrains only while the bundle fits in a half-space.
    cone_ok = (cos_min[:, None] <= 0.0) | (
        sup >= cos_min[:, None] * torch.sqrt(gap2))
    return ok & cone_ok


def _general_cull_cuda(o3_tiles, d3_tiles, a_tiles, cmin, cmax):
    """Launch the general-cull kernel (`csrc/cull.cu`); mask as in
    `_general_cull_plain`.  ``T`` and ``R`` come from ``a_tiles``'s
    shape."""
    num_tiles, r = a_tiles.shape
    dev = d3_tiles.device
    o3_tiles, d3_tiles, a_tiles, cmin, cmax = (
        x.contiguous() for x in (o3_tiles, d3_tiles, a_tiles, cmin, cmax))
    for name, x in (("o3_tiles", o3_tiles), ("d3_tiles", d3_tiles)):
        _check_cuda(name, x, dev, torch.float32, (num_tiles, 3, r))
    _check_cuda("a_tiles", a_tiles, dev, torch.bool, (num_tiles, r))
    _check_boxes(cmin, cmax, dev)
    survive = torch.empty((num_tiles, cmin.shape[0]), dtype=torch.bool,
                          device=dev)
    err = kernel_fn("rt_general_cull")(
        o3_tiles.data_ptr(), d3_tiles.data_ptr(), a_tiles.data_ptr(),
        num_tiles, r, cmin.data_ptr(), cmax.data_ptr(), cmin.shape[0],
        survive.data_ptr(), raw_stream(dev))
    if err:
        raise RuntimeError(f"general cull launch failed: CUDA error {err}")
    launch_counts["general_cull"] += 1
    return survive


def general_tile_cull(
    o3_tiles: torch.Tensor,
    d3_tiles: torch.Tensor,
    a_tiles: torch.Tensor,
    cmin: torch.Tensor,
    cmax: torch.Tensor,
) -> torch.Tensor:
    """Conservative ``[T, C]`` cluster cull for tile-coherent ray bundles
    (planar ``[T, 3, R]`` origins and unit directions, ``[T, R]`` bool
    activity), over each tile's active rays only.  Tiles with no active
    ray cull everything.  The plain chain for CPU tensors, one kernel
    launch for CUDA tensors; inputs that require grad are culled
    detached."""
    run = _pick(d3_tiles, _general_cull_plain, _general_cull_cuda)
    return run(o3_tiles.detach(), d3_tiles.detach(), a_tiles, cmin.detach(),
               cmax.detach())


def _general_lists(o3_tiles, d3_tiles, a_tiles, cs):
    """`general_tile_cull` and its lists, span ``sweep.general_cull``;
    counter ``general_pairs`` adds the (group, cluster) pairs listed, a
    count the host holds once the lists' ``nonzero`` has returned."""
    with span("sweep.general_cull"):
        lists = _tile_lists(general_tile_cull(o3_tiles, d3_tiles, a_tiles,
                                              cs.cmin, cs.cmax))
        count("general_pairs", lists.ids.numel())
        return lists


def trace_shade_general_planar(
    cs,
    shade_blocks: torch.Tensor,
    has_uv: bool,
    o3_tiles: torch.Tensor,
    d3_tiles: torch.Tensor,
    a_tiles: torch.Tensor,
    trace_cfg: TraceConfig = TraceConfig(),
):
    """Closest hit plus attributes for a tile-coherent bundle: planar
    ``[T, 3, R]`` origins and directions, ``[T, R]`` bool activity.
    Returns planar ``[T, R]`` ``(t, slot, u, v, nx, ny, nz, ar, ag, ab[,
    tex, tu, tv], refl)``; inactive rays carry the miss defaults."""
    lists = _general_lists(o3_tiles, d3_tiles, a_tiles, cs)
    with span("sweep.F"):
        run = _pick(d3_tiles, _general_shade_plain, _general_shade_cuda)
        return run(lists, o3_tiles.contiguous(), d3_tiles.contiguous(),
                   a_tiles.contiguous(), shade_blocks, has_uv,
                   t_eps_of(trace_cfg), segment_blocks(cs))


def group_rays(x: torch.Tensor, rays_per_group: int) -> torch.Tensor:
    """Row-major ``[N, ...]`` -> ``[ceil(N / r), r, ...]`` groups of ``r``
    consecutive rays in their given order, the last one padded with
    zeros (False for a mask)."""
    n = x.shape[0]
    groups = -(-n // rays_per_group)
    pad = groups * rays_per_group - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x.reshape((groups, rays_per_group) + tuple(x.shape[1:]))


def trace_rays(
    cs,
    tri_blocks: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    rays_per_group: int = 256,
    trace_cfg: TraceConfig = TraceConfig(),
    active: torch.Tensor | None = None,
) -> Hit:
    """Closest hit of any row-major ray bundle, ``origins`` and ``dirs``
    ``[N, 3]`` -> `Hit` with ``[N]`` fields; ``face`` is the winner's
    original face id (int32), -1 on a miss.  The rays go in groups of
    ``rays_per_group`` through `general_tile_cull` (on unit directions)
    and C's epilogue over F's sweep; ``tri_blocks`` is
    `segment_blocks(cs)`.  A ray that ``active`` ``[N]`` (bool, all when
    None) leaves out returns a miss, as in JAX's
    `dense.trace_clusters_rays(..., active=)`.  While program tracing is
    on it records ``sweep.general_cull`` and ``sweep.probes`` (the
    sweep), and counter ``general_pairs`` adds the (group, cluster) pairs
    the groups listed: rays that arrive in screen order list fewer
    clusters a group."""
    n = origins.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dirs.device)
    num = group_rays(active, rays_per_group)
    o3 = group_rays(origins, rays_per_group).transpose(1, 2).contiguous()
    d3 = group_rays(dirs, rays_per_group).transpose(1, 2).contiguous()
    # The cone test of the cull reads unit directions.
    dlen = torch.sqrt(torch.clamp((d3 * d3).sum(dim=1, keepdim=True),
                                  min=1e-30))
    lists = _general_lists(o3, d3 / dlen, num, cs)
    with span("sweep.probes"):
        run = _pick(d3, _closest_rays_plain, _closest_rays_cuda)
        bt, bu, bv, bs = (x.reshape(-1)[:n] for x in run(
            lists, o3, d3, num, tri_blocks, t_eps_of(trace_cfg)))
    # A miss already carries FLT_MAX, u = v = 0 and slot 0.
    face = torch.where(bt < FLT_MAX, cs.face_order[bs.long()], -1)
    return Hit(t=bt, u=bu, v=bv, face=face.to(torch.int32))


def _coherence_perm(ox, oy, oz, dx, dy, dz, active, lo, hi):
    """``[N]`` permutation and its inverse: active rays grouped by origin
    Morton code (5 bits per axis), then by a 3-bit-per-axis direction
    bucket; inactive rays last.  Keys are int64; the sort is stable, as
    `jnp.argsort` is."""
    from ..accel.bvh import morton_codes

    def q3(v):  # direction component -> 3 bits (sign folded in)
        return torch.clamp((v + 1.0) * 4.0, 0.0, 7.999).to(torch.int64)

    dirb = (q3(dx) << 6) | (q3(dy) << 3) | q3(dz)  # 9 bits
    m = morton_codes(torch.stack([ox, oy, oz], dim=-1), lo, hi, bits=5)
    key = torch.where(active, (m << 9) | dirb, 1 << 30)
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return perm, inv


def _planar(x, y, z, num_tiles, rays):
    """Three flat ``[N]`` planes -> planar ``[T, 3, R]`` tiles."""
    return torch.stack([x.reshape(num_tiles, rays), y.reshape(num_tiles, rays),
                        z.reshape(num_tiles, rays)], dim=1)


def render_bounces_tiled(
    cs,
    shade_blocks: torch.Tensor,
    has_uv: bool,
    textures,
    eye: torch.Tensor,
    dirs: torch.Tensor,
    height: int,
    width: int,
    tile_px: int = 16,
    num_bounces: int = 2,
    light_dir=(0.4, 0.8, -0.45),
    with_shadows: bool = True,
    background=(0.0, 1.0, 0.0),
    ambient: float = 0.08,
    trace_cfg: TraceConfig = TraceConfig(),
    sort_bounces: bool = False,
) -> torch.Tensor:
    """Pinhole frame with mirror bounces on the kernels -> ``[H*W, 3]``
    float RGB (row-major); ``height`` and ``width`` multiples of the tile.

    Each depth contributes ``T_k (1 - r_k) local_k`` with throughput
    ``T_{k+1} = T_k r_k``; the last depth and misses close the sum.
    Shadow rays leave lit hits only (``n.l > 0`` on the normal faced
    against the ray), offset by ``t_epsilon * max(max(cmax) - min(cmin),
    1)`` along the light."""
    dev = dirs.device
    with host_copies("sync.constants", (trace_cfg.t_epsilon, light_dir),
                     dev):
        t_eps = torch.tensor(trace_cfg.t_epsilon, dtype=torch.float32,
                             device=dev)
        light = torch.tensor(light_dir, dtype=torch.float32, device=dev)
    eps = t_eps * torch.clamp(cs.cmax.max() - cs.cmin.min(), min=1.0)
    light = normalize(light)
    bg = background
    T = (height // tile_px) * (width // tile_px)
    R = tile_px * tile_px

    d3_tiles = tile_pixels_planar(dirs.T, height, width, tile_px)
    outs = trace_shade_tiles_planar(cs, shade_blocks, has_uv, eye, d3_tiles,
                                    tile_px=tile_px, trace_cfg=trace_cfg,
                                    with_refl=True)

    dx = d3_tiles[:, 0, :].reshape(-1)
    dy = d3_tiles[:, 1, :].reshape(-1)
    dz = d3_tiles[:, 2, :].reshape(-1)
    with span("frame.shadow_rays"):
        hitm, nx, ny, nz, ndotl = faced_ndotl_planar(outs, d3_tiles, light)
        if with_shadows:
            # Back-facing surfaces shade to ambient whether occluded or
            # not.
            nx0, ny0, nz0 = (o.reshape(-1) for o in outs[4:7])
            nl = torch.sqrt(torch.clamp(nx0 * nx0 + ny0 * ny0 + nz0 * nz0,
                                        min=1e-30))
            ncos = (nx0 * dx + ny0 * dy + nz0 * dz) / nl
            ndl = (nx0 * light[0] + ny0 * light[1] + nz0 * light[2]) / nl
            ndl = torch.where(ncos > 0, -ndl, ndl)
            sactive = (hitm & (ndl > 0.0)).reshape(T, R)
            so = shadow_origins_planar(eye, d3_tiles, outs[0], sactive,
                                       light, eps)
    if with_shadows:
        shadow = occlusion_tiles_planar(cs, so, light, sactive,
                                        tile_px=tile_px, trace_cfg=trace_cfg)

    with span("frame.shade"):
        if with_shadows:
            ndotl = torch.where(shadow.reshape(-1), 0.0, ndotl)
        r0, g0, b0 = lambert_planar(outs, ndotl, textures, has_uv, ambient)
        r0 = torch.where(hitm, r0, bg[0])
        g0 = torch.where(hitm, g0, bg[1])
        b0 = torch.where(hitm, b0, bg[2])
        if num_bounces == 0:
            rgb = torch.stack([r0, g0, b0], dim=-1)
            return untile_pixels(rgb.reshape(T, R, 3), height, width,
                                 tile_px)
        refl = torch.where(hitm, outs[-1].reshape(-1), 0.0)
        cr = (1.0 - refl) * r0
        cg = (1.0 - refl) * g0
        cb = (1.0 - refl) * b0
        throughput = refl
        active = hitm & (refl > 0.0)

    scene_lo = cs.cmin.amin(dim=0)
    scene_hi = cs.cmax.amax(dim=0)
    ox_, oy_, oz_ = eye[0], eye[1], eye[2]
    t = outs[0].reshape(-1)
    for b in range(num_bounces):
        with span("bounce.rays"):
            # Reflect d about the faced normal at the hit point, the origin
            # offset along the normal (planar).
            t_ = torch.clamp(t, max=_BIG)
            px = ox_ + dx * t_
            py = oy_ + dy * t_
            pz = oz_ + dz * t_
            ddn = dx * nx + dy * ny + dz * nz
            dx = dx - 2.0 * ddn * nx
            dy = dy - 2.0 * ddn * ny
            dz = dz - 2.0 * ddn * nz
            ox_, oy_, oz_ = px + nx * eps, py + ny * eps, pz + nz * eps
            d3 = _planar(dx, dy, dz, T, R)
            if sort_bounces:
                perm, invp = _coherence_perm(ox_, oy_, oz_, dx, dy, dz,
                                             active, scene_lo, scene_hi)
                rays = (_planar(ox_[perm], oy_[perm], oz_[perm], T, R),
                        _planar(dx[perm], dy[perm], dz[perm], T, R),
                        active[perm].reshape(T, R))
            else:
                rays = (_planar(ox_, oy_, oz_, T, R), d3,
                        active.reshape(T, R))
        outs = trace_shade_general_planar(cs, shade_blocks, has_uv, *rays,
                                          trace_cfg=trace_cfg)
        with span("bounce.shade"):
            if sort_bounces:
                # Back to pixel order: one gather per output plane.
                outs = tuple(o.reshape(-1)[invp].reshape(T, R)
                             for o in outs)
            hitm, nx, ny, nz, ndotl = faced_ndotl_planar(outs, d3, light)
            lr, lg, lb = lambert_planar(outs, ndotl, textures, has_uv,
                                        ambient)
            lr = torch.where(hitm, lr, bg[0])
            lg = torch.where(hitm, lg, bg[1])
            lb = torch.where(hitm, lb, bg[2])
            refl = torch.where(hitm, outs[-1].reshape(-1), 0.0)
            if b == num_bounces - 1:
                refl = torch.zeros_like(refl)
            wgt = torch.where(active, throughput * (1.0 - refl), 0.0)
            cr = cr + wgt * lr
            cg = cg + wgt * lg
            cb = cb + wgt * lb
            throughput = throughput * refl
            t = outs[0].reshape(-1)
            active = active & hitm & (refl > 0.0)

    rgb = torch.stack([cr, cg, cb], dim=-1)
    return untile_pixels(rgb.reshape(T, R, 3), height, width, tile_px)
