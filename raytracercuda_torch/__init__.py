"""raytracercuda_torch — the ray tracer on PyTorch, with hand-written CUDA
kernels for Hopper.

The counterpart of `raytracercuda_tpu`, one slice at a time; module paths
match the JAX package's.  This package imports torch and never jax.  It
covers the bench frame (`trace.frame.FrameRenderer`), the differentiable
render of `diff.render_grad`, the multi-bounce frame
(`trace.bounce.render_bounces`) and the public API below on BVH (the
default structure), GRID, WAVEFRONT, CLUSTER and BRUTE scenes.

Public API (the reference's `Beam.h`):
  IRenderTarget -> models.render_target.RenderTarget
  IMesh         -> models.mesh.Mesh
  IScene        -> models.scene.Scene
  ICamera       -> models.camera.Camera
  ERROR_*       -> errors
  VERTEX_DATA_* -> models.mesh
"""

from .config import (
    AccelKind,
    BvhConfig,
    ClusterConfig,
    DEFAULT_CONFIG,
    DiffConfig,
    GridConfig,
    RenderConfig,
    TraceConfig,
    WavefrontConfig,
)
from .errors import (
    ERROR_ALL_FINE,
    ERROR_GPU_ALLOC_FAIL,
    ERROR_INVALID_FORMAT,
    ERROR_INVALID_PARAMETER,
    ERROR_LOCK_FIRST,
    ERROR_NO_RENDER_TARGET,
    ERROR_NO_VERTICES,
    ERROR_RT_CAM_MISMATCH,
    ERROR_UNLOCK_FIRST,
    BeamError,
)
from .models.camera import Camera, camera_ray_grid, orient_from_pan_pitch
from .models.mesh import (
    Mesh,
    VERTEX_DATA_BITANGENT,
    VERTEX_DATA_COUNT,
    VERTEX_DATA_EXTRA1,
    VERTEX_DATA_EXTRA2,
    VERTEX_DATA_EXTRA3,
    VERTEX_DATA_EXTRA4,
    VERTEX_DATA_NORMAL,
    VERTEX_DATA_POSITION,
    VERTEX_DATA_TANGENT,
    VERTEX_DATA_UV1,
    VERTEX_DATA_UV2,
)
from .models.render_target import RenderTarget
from .models.scene import Material, Scene, SceneData, flatten_meshes
from .types import FLT_MAX, Hit, Rays

__version__ = "0.1.0"

__all__ = ["AccelKind", "BeamError", "BvhConfig", "Camera",
           "camera_ray_grid", "ClusterConfig", "DEFAULT_CONFIG", "DiffConfig",
           "ERROR_ALL_FINE", "ERROR_GPU_ALLOC_FAIL", "ERROR_INVALID_FORMAT",
           "ERROR_INVALID_PARAMETER", "ERROR_LOCK_FIRST",
           "ERROR_NO_RENDER_TARGET", "ERROR_NO_VERTICES",
           "ERROR_RT_CAM_MISMATCH", "ERROR_UNLOCK_FIRST", "flatten_meshes",
           "FLT_MAX", "GridConfig", "Hit", "Material", "Mesh",
           "orient_from_pan_pitch", "Rays", "RenderConfig", "RenderTarget",
           "Scene", "SceneData", "TraceConfig", "VERTEX_DATA_BITANGENT",
           "VERTEX_DATA_COUNT", "VERTEX_DATA_EXTRA1", "VERTEX_DATA_EXTRA2",
           "VERTEX_DATA_EXTRA3", "VERTEX_DATA_EXTRA4", "VERTEX_DATA_NORMAL",
           "VERTEX_DATA_POSITION", "VERTEX_DATA_TANGENT", "VERTEX_DATA_UV1",
           "VERTEX_DATA_UV2", "WavefrontConfig"]
