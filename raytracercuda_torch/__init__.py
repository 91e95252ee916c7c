"""raytracercuda_torch — the ray tracer on PyTorch, with hand-written CUDA
kernels for Hopper.

The counterpart of `raytracercuda_tpu`, one slice at a time; module paths
match the JAX package's.  This package imports torch and never jax.  The
first slice is the bench frame: `trace.frame.FrameRenderer` on a CLUSTER
scene.
"""

from .config import AccelKind, ClusterConfig, RenderConfig, TraceConfig
from .models.scene import Scene, SceneData

__all__ = ["AccelKind", "ClusterConfig", "RenderConfig", "Scene",
           "SceneData", "TraceConfig"]
