"""raytracercuda_torch — the ray tracer on PyTorch, with hand-written CUDA
kernels for Hopper.

The counterpart of `raytracercuda_tpu`, one slice at a time; module paths
match the JAX package's.  This package imports torch and never jax.  It
covers the bench frame (`trace.frame.FrameRenderer`), the differentiable
render of `diff.render_grad`, the multi-bounce frame
(`trace.bounce.render_bounces`) and the public API below on BVH (the
default structure), WAVEFRONT, CLUSTER and BRUTE scenes; GRID comes with a
later slice.

Public API (the reference's `Beam.h`):
  IRenderTarget -> models.render_target.RenderTarget
  IMesh         -> models.mesh.Mesh
  IScene        -> models.scene.Scene
  ICamera       -> models.camera.Camera
  ERROR_*       -> errors
"""

from .config import (AccelKind, BvhConfig, ClusterConfig, RenderConfig,
                     TraceConfig)
from .errors import (
    ERROR_ALL_FINE,
    ERROR_INVALID_PARAMETER,
    ERROR_LOCK_FIRST,
    ERROR_NO_RENDER_TARGET,
    ERROR_RT_CAM_MISMATCH,
    ERROR_UNLOCK_FIRST,
)
from .models.camera import Camera, camera_ray_grid, orient_from_pan_pitch
from .models.mesh import Mesh
from .models.render_target import RenderTarget
from .models.scene import Material, Scene, SceneData

__all__ = ["AccelKind", "BvhConfig", "Camera", "ClusterConfig",
           "ERROR_ALL_FINE", "ERROR_INVALID_PARAMETER", "ERROR_LOCK_FIRST",
           "ERROR_NO_RENDER_TARGET", "ERROR_RT_CAM_MISMATCH",
           "ERROR_UNLOCK_FIRST", "Material", "Mesh", "RenderConfig",
           "RenderTarget", "Scene", "SceneData", "TraceConfig",
           "camera_ray_grid", "orient_from_pan_pitch"]
