"""The port's light-space shadow grid (`trace/shadow.py`: `build_shadow_grid`,
`occlusion_grid`) against the JAX package's, on the CPU, on the five
cases of `tests/test_shadow.py`.

Tolerances, stated per check:

  * the build: ``cell_start`` and ``entry_tris`` exactly equal (the
    projections are rounded as XLA's contracted dot products,
    `ops/math.dot_fused`), the float fields (axes, ``uv_min``,
    ``inv_cell``) within 1e-6 relative;
  * the masks: exactly equal to JAX's, and to the port's brute-force
    any-hit (`any_hit_brute`), as JAX's are to its own.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (checks the port imports no jax first)
from test_shadow import random_mesh

import jax.numpy as jnp

from raytracercuda_tpu.trace.shadow import build_shadow_grid as jax_build
from raytracercuda_tpu.trace.shadow import occlusion_grid as jax_occlusion

from raytracercuda_torch import interop
from raytracercuda_torch.trace.bruteforce import any_hit_brute
from raytracercuda_torch.trace.shadow import (ShadowGrid, build_shadow_grid,
                                              occlusion_grid)
from raytracercuda_torch.types import FLT_MAX

# name: (faces, seed, res, max_cells_per_face, light, chunk, scale) from
# tests/test_shadow.py's `_check` cases.
CASES = {
    "matches_brute": (120, 7, 32, 16, [0.3, 0.8, -0.5], 8, 0.3),
    "axis_aligned_light": (80, 8, 16, 16, [1.0, 0.0, 0.0], 8, 0.3),
    "overflow_bucket": (60, 9, 64, 2, [0.2, -0.7, 0.6], 8, 0.8),
    "wide_chunk": (120, 7, 32, 16, [0.3, 0.8, -0.5], 32, 0.3),
}


def grids(positions, faces, light, **kw):
    jg = jax_build(positions, faces, jnp.asarray(light), **kw)
    tg = build_shadow_grid(torch.from_numpy(np.array(positions)),
                           torch.from_numpy(np.array(faces, np.int64)),
                           torch.from_numpy(np.asarray(light, np.float32)),
                           **kw)
    return jg, tg


def assert_grids_equal(tg: ShadowGrid, jg) -> None:
    assert tg.res == jg.res
    for name in ("cell_start", "entry_tris"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    for name in ("u_axis", "v_axis", "l_axis", "uv_min", "inv_cell"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shadow_grid_matches_jax(case):
    num_faces, seed, res, kmax, light, chunk, scale = CASES[case]
    positions, faces = random_mesh(num_faces, seed=seed, scale=scale)
    light = np.asarray(light, np.float32)
    jg, tg = grids(positions, faces, light, res=res, max_cells_per_face=kmax)
    assert_grids_equal(tg, jg)
    rng = np.random.default_rng(seed + 1)
    origins = rng.uniform(-2.5, 2.5, (512, 3)).astype(np.float32)
    origins[:, 2] += 3.0
    active = rng.random(512) < 0.7
    want = np.asarray(jax_occlusion(jg, jnp.asarray(origins),
                                    jnp.asarray(active), chunk=chunk))
    got = occlusion_grid(tg, torch.from_numpy(origins),
                         torch.from_numpy(active), chunk=chunk)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    tp = torch.from_numpy(np.array(positions))
    tf = torch.from_numpy(np.array(faces, np.int64))
    brute = any_hit_brute(tp, tf, torch.from_numpy(origins),
                          tg.l_axis.expand(512, 3).contiguous(),
                          float(FLT_MAX))
    np.testing.assert_array_equal(got.numpy(),
                                  (brute & torch.from_numpy(active)).numpy())
    assert want.any()
    if case == "overflow_bucket":  # most triangles went to the overflow
        ov = tg.cell_start[res * res + 1] - tg.cell_start[res * res]
        assert int(ov) > num_faces // 2


def test_shadow_grid_no_active_rays():
    positions, faces = random_mesh(10, seed=10)
    _, tg = grids(positions, faces, np.array([0.0, 0.0, 1.0], np.float32))
    out = occlusion_grid(tg, torch.zeros(64, 3),
                         torch.zeros(64, dtype=torch.bool))
    assert not out.any()


def test_shadow_grid_single_occluder():
    """A wall at z = 5 lit along +z: points before it are occluded, points
    past it are not (`tests/test_shadow.py:66`); the JAX grid carried over
    by `shadow_grid_from_numpy` gives the same masks."""
    positions = np.array([[-10, -10, 5], [10, -10, 5], [0, 18, 5]],
                         np.float32)
    faces = np.array([[0, 1, 2, 0]], np.int32)
    light = np.array([0.0, 0.0, 1.0], np.float32)
    jg, tg = grids(jnp.asarray(positions), jnp.asarray(faces), light)
    assert_grids_equal(tg, jg)
    origins = torch.tensor([[0, 0, 0], [0, 0, 6], [0, 0, 4.9]])
    active = torch.ones(3, dtype=torch.bool)
    assert occlusion_grid(tg, origins, active).tolist() == [True, False,
                                                            True]
    carried = interop.shadow_grid_from_numpy(
        *(np.asarray(getattr(jg, n)) for n in ShadowGrid._fields[:-1]),
        jg.res, device="cpu")
    assert_grids_equal(carried, jg)
    assert occlusion_grid(carried, origins, active).tolist() == [True, False,
                                                                 True]
