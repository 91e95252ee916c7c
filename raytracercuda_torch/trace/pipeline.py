"""Forward render pipeline: camera rays -> closest hit -> shade -> packed
framebuffer (counterpart of `raytracercuda_tpu/trace/pipeline.py`).

`trace_hit` dispatches on the configured structure:

  * BRUTE (or no structure) traces every ray against every face through
    kernel E (`bruteforce.trace_brute`);
  * CLUSTER traces pinhole frames (all rays leaving ``common_origin``)
    through kernel C (`sweep.trace_dense`); a frame that the tile does not
    divide is edge-padded and cropped;
  * CLUSTER traces any other ray bundle (JAX: `dense.trace_clusters_rays`)
    in groups of one tile's count of rays, in their given order, through
    the general cull and C's epilogue over F's sweep
    (`bounce_sweep.trace_rays`).

  * BVH traces a pinhole frame that ``beam_tile`` divides through kernel L
    (`beam.trace_beam`, with ``use_beam``), and any other frame or bundle
    through kernel K's per-ray walk (`traverse.trace_bvh`), as the
    reference does: no edge-padding here;
  * GRID traces every frame and bundle through kernel M's march
    (`grid_march.trace_grid`), a pinhole frame on pixel-patch warps with
    the eye's terms staged;
  * WAVEFRONT traces through `wavefront.trace_wavefront` (plain PyTorch).

`occlusion_hit` is its any-hit counterpart, the one place where a shadow
ray's kernel is chosen for row-major rays: E on BRUTE and GRID, K's
any-hit walk on BVH and WAVEFRONT, H on CLUSTER.  `shadow_origins` builds
those rays' origins; each caller passes its own rule's offset and clamp.
The planar tiles of the CLUSTER frames build theirs with
`shade.shadow_origins_planar` and run kernel B.
"""

from __future__ import annotations

import torch

from ..config import AccelKind, RenderConfig
from ..types import FLT_MAX, Hit
from ..utils.profiler import span


def rotate_rays(initial_rays: torch.Tensor,
                orient: torch.Tensor) -> torch.Tensor:
    """``dir = orient * initialRays[i]``: ``initial_rays @ orient.T``,
    written per component so the three products sum in one fixed order on
    every device (no TF32 on the card)."""
    r = initial_rays
    return (r[:, 0:1] * orient[:, 0] + r[:, 1:2] * orient[:, 1]
            + r[:, 2:3] * orient[:, 2])


def pad_frame(x: torch.Tensor, height: int, width: int, tile_px: int):
    """Row-major ``[H*W, ...]`` pixels edge-padded to whole tiles: the last
    row and column repeat.  Returns ``(x_padded, hp, wp)``."""
    hp = -(-height // tile_px) * tile_px
    wp = -(-width // tile_px) * tile_px
    if (hp, wp) == (height, width):
        return x, hp, wp
    img = x.reshape((height, width) + tuple(x.shape[1:]))
    rows = torch.arange(hp, device=x.device).clamp(max=height - 1)
    cols = torch.arange(wp, device=x.device).clamp(max=width - 1)
    return img[rows][:, cols].reshape((hp * wp,) + tuple(x.shape[1:])), hp, wp


def crop_frame(x: torch.Tensor, height: int, width: int, hp: int, wp: int):
    """Inverse of `pad_frame`: drop the padded rows and columns."""
    if (hp, wp) == (height, width):
        return x
    tail = tuple(x.shape[1:])
    return x.reshape((hp, wp) + tail)[:height, :width].reshape(
        (height * width,) + tail)


def trace_hit(
    scene,
    accel,
    origin: torch.Tensor,
    direction: torch.Tensor,
    config: RenderConfig,
    frame_hw: tuple[int, int] | None = None,
    common_origin: torch.Tensor | None = None,
) -> Hit:
    """Closest hit of row-major rays over the configured structure.
    ``frame_hw`` + ``common_origin`` mark a pinhole frame, which the
    CLUSTER route traces as pixel tiles, the BVH route as tile beams and
    the GRID route on pixel-patch warps from the staged eye."""
    kind = config.accel
    tc = config.trace
    if kind == AccelKind.BRUTE or accel is None:
        from .bruteforce import trace_brute

        return trace_brute(scene.positions, scene.faces, origin, direction,
                           tc)
    if kind == AccelKind.BVH:
        if (tc.use_beam and frame_hw is not None
                and common_origin is not None
                and frame_hw[0] % tc.beam_tile == 0
                and frame_hw[1] % tc.beam_tile == 0):
            from .beam import trace_beam

            return trace_beam(accel, common_origin, direction,
                              height=frame_hw[0], width=frame_hw[1],
                              tile_px=tc.beam_tile, queue=tc.beam_queue,
                              cfg=config.bvh, trace_cfg=tc,
                              tiles_per_chunk=tc.beam_tiles_per_chunk)
        from .traverse import trace_bvh

        return trace_bvh(accel, scene.positions, scene.faces, origin,
                         direction, config.bvh, tc)
    if kind == AccelKind.GRID:
        from .grid_march import trace_grid

        return trace_grid(accel, scene.positions, scene.faces, origin,
                          direction, config.grid, tc, frame_hw=frame_hw,
                          common_origin=common_origin)
    if kind == AccelKind.WAVEFRONT:
        from .wavefront import trace_wavefront

        return trace_wavefront(accel, scene.positions, scene.faces, origin,
                               direction, config.bvh, tc)
    if kind != AccelKind.CLUSTER:
        raise ValueError(f"unknown accel kind {kind}")
    from .sweep import segment_blocks, trace_dense

    tp = tc.dense_tile_px
    if frame_hw is None or common_origin is None:
        from .bounce_sweep import trace_rays

        return trace_rays(accel, segment_blocks(accel), origin, direction,
                          rays_per_group=tp * tp, trace_cfg=tc)
    height, width = frame_hw
    # Edge-pad a frame the tile does not divide: the repeated edge rays are
    # valid directions, and their pixels are cropped.
    dirs, hp, wp = pad_frame(direction, height, width, tp)
    hit = trace_dense(accel, segment_blocks(accel), common_origin, dirs,
                      height=hp, width=wp, tile_px=tp, trace_cfg=tc)
    return Hit(*(crop_frame(x, height, width, hp, wp) for x in hit))


def occlusion_hit(
    scene,
    accel,
    origins: torch.Tensor,
    light: torch.Tensor,
    active: torch.Tensor,
    config: RenderConfig,
    frame_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Any hit toward the unit directional ``light`` ``[3]`` from row-major
    ``origins`` ``[N, 3]`` -> ``[N]`` bool, true only where ``active``
    ``[N]`` and occluded.  The counterpart of `trace_hit`, on the same
    structures: E on BRUTE (or no structure) and GRID, K's any-hit walk on
    BVH and WAVEFRONT (``t_max`` 0 ends an inactive ray's walk at the
    root), and H over the swept-beam lists on CLUSTER (``frame_hw``
    marks a frame, edge-padded and cropped; any other bundle goes in
    groups of one tile's count of rays, in their given order)."""
    kind = config.accel
    tc = config.trace
    if kind in (AccelKind.BRUTE, AccelKind.GRID) or accel is None:
        from .bruteforce import any_hit_brute

        return any_hit_brute(scene.positions, scene.faces, origins,
                             light.expand(origins.shape), float(FLT_MAX),
                             tc) & active
    if kind in (AccelKind.BVH, AccelKind.WAVEFRONT):
        from .traverse import any_hit_bvh

        t_max = torch.where(active, float(FLT_MAX), 0.0)
        return any_hit_bvh(accel, scene.positions, scene.faces, origins,
                           light.expand(origins.shape), t_max, config.bvh,
                           tc)
    if kind != AccelKind.CLUSTER:
        raise ValueError(f"unknown accel kind {kind}")
    from .sweep import occlusion_dense, occlusion_tiles, segment_blocks

    tp = tc.dense_tile_px
    if frame_hw is None:
        from .bounce_sweep import group_rays

        r = tp * tp
        return occlusion_tiles(
            accel, segment_blocks(accel), group_rays(origins, r).contiguous(),
            light, group_rays(active, r), tile_px=tp,
            trace_cfg=tc)[:active.shape[0]]
    height, width = frame_hw
    so, hp, wp = pad_frame(origins, height, width, tp)
    act, _, _ = pad_frame(active, height, width, tp)
    return crop_frame(occlusion_dense(
        accel, segment_blocks(accel), so, light, act, height=hp, width=wp,
        tile_px=tp, trace_cfg=tc), height, width, hp, wp)


def shadow_origins(origin: torch.Tensor, dirs: torch.Tensor,
                   t: torch.Tensor, hit_mask: torch.Tensor,
                   light: torch.Tensor, eps, t_clamp: float) -> torch.Tensor:
    """Row-major ``[N, 3]`` shadow-ray origins: each hit point (``t``
    clamped at ``t_clamp``), or the ray's own origin where ``hit_mask`` is
    false, pushed ``eps`` along ``light``.  Each route passes its own eps
    and clamp."""
    p = origin + dirs * torch.clamp(t, max=t_clamp)[..., None]
    return torch.where(hit_mask[..., None], p, origin) + light * eps


def trace_to_buffer(
    scene,
    accel,
    initial_rays: torch.Tensor,
    eye: torch.Tensor,
    orient: torch.Tensor,
    config: RenderConfig,
    frame_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Parity frame: the ``[R]`` packed uint32 framebuffer that the
    reference's march kernels write (`BuildTree.cu:486-496`).  Traced:
    spans ``frame.rays``, ``frame.trace`` (`trace_hit`) and
    ``frame.shade``."""
    from .shade import shade_normal_packed

    with span("frame.rays"):
        dirs = rotate_rays(initial_rays, orient)
        origin = eye[None, :].expand(dirs.shape)
    with span("frame.trace"):
        hit = trace_hit(scene, accel, origin, dirs, config,
                        frame_hw=frame_hw, common_origin=eye)
    with span("frame.shade"):
        return shade_normal_packed(scene, hit)
