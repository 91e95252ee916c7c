"""FrameRenderer: pinhole frames of one scene (counterpart of
`raytracercuda_tpu/trace/frame.py:54-251`).

On a CLUSTER scene (the JAX package's two-stage kernel route) one `render`
call:

  1. rotates the ray grid into planar ``[3, N]`` directions and tiles it
     ``[T, 3, R]``;
  2. culls each tile's frustum against the cluster boxes and runs kernel A
     (closest hit + interpolated normal, albedo, uv);
  3. faces the normals, builds shadow origins toward a directional light
     (`shade.shadow_setup`: one kernel on the card) and runs kernel B (any
     hit) over the swept-beam cull;
  4. shades with Lambert, textured where the scene has uvs and a texture,
     and writes ``0x00RRGGBB`` in row-major order (`shade.frame_shade`:
     one kernel on the card).

Shade blocks are built once per (scene, clusters) pair.  On any other
structure (BVH, GRID, WAVEFRONT, or none for BRUTE; JAX `_frame_xla`) it
traces with `pipeline.trace_hit`, tests shadows from the origins of
`pipeline.shadow_origins` (offset by ``light * shadow_eps``) with
`pipeline.occlusion_hit`, which picks the any-hit kernel, and shades
through the per-face rows of `shade.build_face_tables`.  The tensors'
device picks the kernels: CUDA kernels on a GPU, their plain PyTorch
versions on the CPU.
"""

from __future__ import annotations

import torch

from ..accel.clusters import ClusterSet
from ..config import RenderConfig
from ..models.scene import SceneData
from ..ops.math import normalize
from ..utils.profiler import span
from .dense import tile_pixels_planar
from .pipeline import occlusion_hit, rotate_rays, shadow_origins, trace_hit
from .shade import (build_face_tables, frame_shade, pack_shaded,
                    shade_lambert_rgb, shadow_setup)
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
        with span("frame.shadow_rays"):
            ndotl, active, o3 = shadow_setup(outs, d3_tiles, eye, self.light,
                                             self.shadow_eps, self.shadows)
        shadow = None
        if self.shadows:
            shadow = occlusion_tiles_planar(
                self.accel, o3, self.light, active, tile_px=self.tile_px,
                trace_cfg=self.config.trace)
        with span("frame.shade"):
            return frame_shade(outs, ndotl, shadow, self.scene.textures,
                               self.has_uv, self.ambient, self.background,
                               self.height, self.width, self.tile_px)

    def _render_rows(self, eye, orient, rays):
        """The route of every structure other than CLUSTER (JAX
        `_frame_xla`): `trace_hit`, `_shadow_rows`, per-face rows."""
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
        with span("frame.shadow_rays"):
            hit_mask = hit.hit_mask  # a property: one launch each read
            so = shadow_origins(origin, dirs, hit.t, hit_mask, self.light,
                                self.shadow_eps, 1e6)
        return occlusion_hit(self.scene, self.accel, so, self.light,
                             hit_mask, self.config)

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
