"""The port's FrameRenderer against the JAX FrameRenderer's Pallas route
(interpret mode) on one numpy scene: packed frames within 1 per u8
channel, with shadows on and off, with and without uvs and a texture, and
with JAX's survivor lists capped narrow enough to take its sort branch."""

import numpy as np
import pytest
import torch

from torch_parity import (
    SIDE,
    assert_u8_close,
    jax_config,
    jax_scene,
    numpy_scene,
    torch_config,
    torch_scene,
)

import jax.numpy as jnp

from raytracercuda_tpu.accel.clusters import build_clusters as jax_build
from raytracercuda_tpu.models.camera import camera_ray_grid as jax_rays
from raytracercuda_tpu.trace.frame import FrameRenderer as JaxFrameRenderer

from raytracercuda_torch.accel.clusters import build_clusters
from raytracercuda_torch.models.camera import camera_ray_grid
from raytracercuda_torch.models.camera import orient_from_pan_pitch
from raytracercuda_torch.trace.frame import FrameRenderer

# (scene kind, shadows, JAX list width, seed).  Width 4 is below the 6-8
# clusters that some tiles list, so JAX takes its sort branch.
CASES = {
    "shadows": ("plain", True, 32, 17),
    "no_shadows": ("plain", False, 32, 23),
    "uv_shadows": ("uv", True, 32, 17),
    "uv_no_shadows": ("uv", False, 32, 17),
    "textured_shadows": ("textured", True, 32, 19),
    "textured_no_shadows": ("textured", False, 32, 19),
    "sort_branch": ("textured", True, 4, 17),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_matches_jax(case):
    kind, shadows, width, seed = CASES[case]
    f = numpy_scene(900, seed=seed, uv=kind == "uv",
                    textured=kind == "textured")
    js, ts = jax_scene(f), torch_scene(f)
    jcfg, tcfg = jax_config(width), torch_config()
    orient = orient_from_pan_pitch(0.05, -0.03)
    want = JaxFrameRenderer(
        js, jax_build(js.positions, js.faces, jcfg.cluster), jcfg, SIDE,
        SIDE, shadows=shadows).render(jnp.zeros(3), jnp.asarray(orient),
                                      jax_rays(SIDE, SIDE))
    renderer = FrameRenderer(ts, build_clusters(ts.positions, ts.faces,
                                                tcfg.cluster),
                             tcfg, SIDE, SIDE, shadows=shadows)
    got = renderer.render(torch.zeros(3), torch.from_numpy(orient),
                          camera_ray_grid(SIDE, SIDE, device="cpu"))
    assert got.shape == (SIDE * SIDE,) and got.dtype == torch.uint32
    want = np.asarray(want)
    assert want.dtype == np.uint32
    assert_u8_close(got.numpy(), want)
    assert (want != want[0]).any()  # the scene is in view
    if kind == "textured":
        assert len(np.unique(want)) > 100  # the texture varies the albedo


def test_frame_size_must_tile():
    f = numpy_scene(300)
    ts = torch_scene(f)
    cfg = torch_config()
    with pytest.raises(ValueError, match="multiple"):
        FrameRenderer(ts, build_clusters(ts.positions, ts.faces,
                                         cfg.cluster), cfg, 40, 64)
