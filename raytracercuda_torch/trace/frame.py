"""FrameRenderer: pinhole frames of one scene (counterpart of
`raytracercuda_tpu/trace/frame.py:54-251`).

On a CLUSTER scene (the JAX package's two-stage kernel route) one `render`
call:

  1. rotates the ray grid into planar ``[3, N]`` directions and tiles it
     ``[T, 3, R]``;
  2. culls each tile's frustum against the cluster boxes and runs kernel A
     (closest hit + interpolated normal, albedo, uv);
  3. builds shadow origins toward a directional light and runs kernel B
     (any hit) over the swept-beam cull;
  4. shades with Lambert (textured where the scene has uvs and a
     texture), packs ``0x00RRGGBB`` and untiles into row-major order.

Shade blocks are built once per (scene, clusters) pair.  On any other
structure (BVH, GRID, WAVEFRONT, or none for BRUTE; JAX `_frame_xla`) it
traces with `pipeline.trace_hit` (kernel L or K on BVH, M on GRID), tests
shadows from origins offset by ``light * shadow_eps`` and shades through
the per-face rows of `shade.build_face_tables`.  On an LBVH (BVH and
WAVEFRONT) the shadow rays walk the tree with `any_hit_bvh` (kernel K's
any hit), each with ``t_max`` FLT_MAX where its primary ray hit and 0
where it missed, so a missed ray's walk ends at the root; BRUTE and GRID
test them with `any_hit_brute` (kernel E) and keep ``shadow & hit_mask``.
Both give the same mask, bit for bit, as JAX `_frame_xla`'s brute-force
test.  The tensors' device picks the kernels: CUDA kernels on a GPU,
their plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import torch

from ..accel.bvh import Bvh
from ..accel.clusters import ClusterSet
from ..config import RenderConfig
from ..models.scene import SceneData
from ..ops.math import normalize, pack_rgb
from ..types import FLT_MAX
from ..utils.profiler import span
from .dense import tile_pixels_planar, untile_pixels
from .shade import (build_face_tables, pack_shaded, sample_texture,
                    shade_lambert_rgb)
from .sweep import (
    occlusion_tiles_planar,
    shade_segment_blocks,
    trace_shade_tiles_planar,
)


class FrameRenderer:
    """Render pinhole frames of one (scene, structure) pair at a fixed
    size."""

    def __init__(
        self,
        scene: SceneData,
        accel,
        config: RenderConfig,
        height: int,
        width: int,
        light_dir=(0.4, 0.8, -0.45),
        ambient: float = 0.08,
        background=(0.0, 1.0, 0.0),
        shadows: bool = True,
    ):
        tp = config.trace.dense_tile_px
        self.clusters = isinstance(accel, ClusterSet)
        if self.clusters and (height % tp or width % tp):
            raise ValueError(f"frame {height}x{width} is not a multiple of "
                             f"the {tp}-pixel tile")
        dev = scene.device
        self.scene = scene
        self.accel = accel
        self.config = config
        self.height, self.width = height, width
        self.tile_px = tp
        self.ambient = float(ambient)
        self.background = tuple(float(c) for c in background)
        self.shadows = shadows
        self.light = normalize(torch.tensor(light_dir, dtype=torch.float32,
                                            device=dev))
        extent = float((scene.positions.amax(dim=0)
                        - scene.positions.amin(dim=0)).amax())
        # Shadow-ray offset scaled to the scene: push the origin toward
        # the light far enough to clear the surface at float precision.
        self.shadow_eps = torch.tensor(config.trace.t_epsilon * extent,
                                       dtype=torch.float32, device=dev)
        if self.clusters:
            self.blocks, self.has_uv = shade_segment_blocks(accel, scene)
        else:
            self.tables = build_face_tables(scene)
            # On the device once: a copy from host memory in each frame
            # would wait for the frame's kernels.
            self.background = torch.tensor(self.background,
                                           dtype=torch.float32, device=dev)

    def _trace(self, eye, orient, rays):
        # dirs = rays @ orient.T, written out per component so the three
        # products sum in one fixed order on every device.
        with span("frame.rays"):
            r = rays.T  # [3, N]
            d3 = (orient[:, 0:1] * r[0] + orient[:, 1:2] * r[1]
                  + orient[:, 2:3] * r[2])
            d3_tiles = tile_pixels_planar(d3, self.height, self.width,
                                          self.tile_px).contiguous()
        outs = trace_shade_tiles_planar(
            self.accel, self.blocks, self.has_uv, eye, d3_tiles,
            tile_px=self.tile_px, trace_cfg=self.config.trace)
        return d3_tiles, outs

    def _shadow_shade(self, eye, d3_tiles, outs):
        tp = self.tile_px
        t = d3_tiles.shape[0]
        with span("frame.shadow_rays"):
            bt = outs[0].reshape(-1)
            nx, ny, nz = (o.reshape(-1) for o in outs[4:7])
            dx = d3_tiles[:, 0, :].reshape(-1)
            dy = d3_tiles[:, 1, :].reshape(-1)
            dz = d3_tiles[:, 2, :].reshape(-1)
            hitm = bt < FLT_MAX

            # normalize(n, eps=1e-30) per component, then face the eye.
            nlen = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                          min=1e-30))
            nx, ny, nz = nx / nlen, ny / nlen, nz / nlen
            flip = nx * dx + ny * dy + nz * dz > 0.0
            nx = torch.where(flip, -nx, nx)
            ny = torch.where(flip, -ny, ny)
            nz = torch.where(flip, -nz, nz)
            lx, ly, lz = self.light[0], self.light[1], self.light[2]
            ndotl = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
            if self.shadows:
                # Shadow rays only where they can change the pixel:
                # surfaces facing away from the light shade to ambient
                # either way.
                active = hitm & (ndotl > 0.0)
                tmin = torch.clamp(bt, max=1e6)
                eps = self.shadow_eps
                sox = (torch.where(active, eye[0] + dx * tmin, eye[0])
                       + lx * eps)
                soy = (torch.where(active, eye[1] + dy * tmin, eye[1])
                       + ly * eps)
                soz = (torch.where(active, eye[2] + dz * tmin, eye[2])
                       + lz * eps)
                o3 = torch.stack([sox.reshape(t, tp * tp),
                                  soy.reshape(t, tp * tp),
                                  soz.reshape(t, tp * tp)], dim=1)
        if self.shadows:
            shadow = occlusion_tiles_planar(
                self.accel, o3, self.light,
                active.reshape(t, tp * tp), tile_px=tp,
                trace_cfg=self.config.trace)
        with span("frame.shade"):
            if self.shadows:
                ndotl = torch.where(shadow.reshape(-1), 0.0, ndotl)
            ar, ag, ab = (o.reshape(-1) for o in outs[7:10])
            textures = self.scene.textures
            if self.has_uv and textures.shape[0] > 0:
                tex_id = outs[10].reshape(-1).to(torch.int32)
                tex_rgb = sample_texture(textures, tex_id,
                                         outs[11].reshape(-1),
                                         outs[12].reshape(-1))
                texd = tex_id >= 0
                ar = torch.where(texd, ar * tex_rgb[:, 0], ar)
                ag = torch.where(texd, ag * tex_rgb[:, 1], ag)
                ab = torch.where(texd, ab * tex_rgb[:, 2], ab)
            lit = self.ambient + (1.0 - self.ambient) * ndotl
            bg = self.background
            r = torch.where(hitm, ar * lit, bg[0])
            g = torch.where(hitm, ag * lit, bg[1])
            b = torch.where(hitm, ab * lit, bg[2])
            packed = pack_rgb(r, g, b)
            return untile_pixels(packed.reshape(t, tp * tp), self.height,
                                 self.width, tp)

    def _render_rows(self, eye, orient, rays):
        """The route of every structure other than CLUSTER (JAX
        `_frame_xla`): `trace_hit`, `_shadow_rows`, per-face rows."""
        from .pipeline import rotate_rays, trace_hit

        with span("frame.rays"):
            dirs = rotate_rays(rays, orient)
            origin = eye[None, :].expand(dirs.shape)
        hit = trace_hit(self.scene, self.accel, origin, dirs, self.config,
                        frame_hw=(self.height, self.width),
                        common_origin=eye)
        shadow = self._shadow_rows(origin, dirs, hit) if self.shadows \
            else None
        with span("frame.shade"):
            rgb = shade_lambert_rgb(self.scene, hit, origin, dirs,
                                    light_dir=self.light, shadow_mask=shadow,
                                    ambient=self.ambient,
                                    background=self.background,
                                    tables=self.tables)
            return pack_shaded(rgb)

    def _shadow_rows(self, origin, dirs, hit):
        """Occlusion toward the light of each primary ray's hit point:
        False wherever the primary ray missed."""
        scene, tc = self.scene, self.config.trace
        with span("frame.shadow_rays"):
            p = origin + dirs * torch.clamp(hit.t, max=1e6)[..., None]
            so = (torch.where(hit.hit_mask[..., None], p, origin)
                  + self.light * self.shadow_eps)
            light = self.light.expand(dirs.shape)
        if isinstance(self.accel, Bvh):
            from .traverse import any_hit_bvh

            # t_max 0 ends a missed ray's walk at the root: not occluded.
            t_max = torch.where(hit.hit_mask, float(FLT_MAX), 0.0)
            return any_hit_bvh(self.accel, scene.positions, scene.faces, so,
                               light, t_max, self.config.bvh, tc)
        from .bruteforce import any_hit_brute

        return any_hit_brute(scene.positions, scene.faces, so, light,
                             float(FLT_MAX), tc) & hit.hit_mask

    def render(self, eye: torch.Tensor, orient: torch.Tensor,
               rays: torch.Tensor) -> torch.Tensor:
        """Packed ``0x00RRGGBB`` row-major framebuffer ``[H*W]`` (uint32)
        for one camera pose.  ``rays``: the pinhole ray grid
        (`camera_ray_grid`), row-major ``[H*W, 3]``; all on the scene's
        device."""
        with span("frame"):
            eye = eye.to(torch.float32)
            orient = orient.to(torch.float32)
            if not self.clusters:
                return self._render_rows(eye, orient, rays)
            d3_tiles, outs = self._trace(eye, orient, rays)
            return self._shadow_shade(eye, d3_tiles, outs)
