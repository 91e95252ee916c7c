"""The port's hash grid (`raytracercuda_torch.accel.grid`) and its
statistics against the JAX package's, on the CPU.

Every check is exact: Fletcher16, `hash3_cells` and `map_cell` equal
(negative cells through the two's-complement u32 cast, ``0xFFFFFFFF``,
cells above 255 whose checksums collide); `build_grid`'s ``cell_start``
and ``entries`` equal to JAX's on the scenes of `tests/test_grid.py`, a
3,000-face bumpy sphere, a build with small caps, and config 2's scene,
where the reference's quad keeps 64 and 1 of its cells (the
``max_cells_per_face`` truncation, kept from the JAX package);
`grid_stats` equal dicts.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (checks the port imports no jax first)
from test_accel_stats import soup
from test_grid import _mesh, scalar_fletcher16

import jax.numpy as jnp

from raytracercuda_tpu.accel import grid as jgrid
from raytracercuda_tpu.accel import stats as jstats
from raytracercuda_tpu.config import GridConfig as JaxGridConfig
from raytracercuda_tpu.models import procedural as jproc
from raytracercuda_tpu.models.scene import flatten_meshes

from raytracercuda_torch import interop
from raytracercuda_torch.accel import grid as tgrid
from raytracercuda_torch.accel import stats as tstats
from raytracercuda_torch.config import GridConfig


def test_fletcher16():
    vals = np.array([0, 1, 255, 256, 0xDEADBEEF, 0xFFFFFFFF, 12345, 65535,
                     0x80000000, 0x7FFFFFFF], np.uint32)
    got = tgrid.fletcher16(torch.from_numpy(vals.astype(np.int64))).numpy()
    want = np.asarray(jgrid.fletcher16(jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert list(got) == [scalar_fletcher16(int(v)) for v in vals]


@pytest.mark.parametrize("num_cells", [65536, 1024, 7])
def test_hash3_cells(num_cells):
    """Negative cells, extremes of int32, and cells 0 and 255 (equal
    checksums: the collision of `tests/test_grid.py:112`)."""
    rng = np.random.default_rng(num_cells)
    cells = np.concatenate([
        np.array([[-1, -2, -3], [0, 0, 0], [5, -5, 7], [0, 0, 255],
                  [2**31 - 1, -2**31, 256]], np.int32),
        rng.integers(-2**31, 2**31, (200, 3)).astype(np.int32),
        rng.integers(-300, 300, (200, 3)).astype(np.int32)])
    got = tgrid.hash3_cells(torch.from_numpy(cells), num_cells).numpy()
    want = np.asarray(jgrid.hash3_cells(jnp.asarray(cells), num_cells))
    np.testing.assert_array_equal(got, want)
    assert got[1] == got[3] and (got < num_cells).all() and (got >= 0).all()


def test_map_cell():
    rng = np.random.default_rng(2)
    p = np.concatenate([
        np.array([[0.0, 0.031, -0.001], [0.03, -0.03, 0.06]], np.float32),
        rng.uniform(-3, 3, (500, 3)).astype(np.float32),
        (rng.integers(-100, 100, (100, 3)) * np.float32(0.03)).astype(
            np.float32)])
    got = tgrid.map_cell(torch.from_numpy(p), 0.03)
    want = np.asarray(jgrid.map_cell(jnp.asarray(p), jnp.float32(0.03)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0].numpy() == [0, 1, -1]).all()


def config2_scene():
    """Config 2's scene at the test size: a 600-face bumpy sphere at the
    origin and the reference's quad at z = 2.5 (faces 600 and 601)."""
    data = flatten_meshes([jproc.bumpy_sphere_mesh(600, center=(0.0, 0.0,
                                                                0.0)),
                           jproc.quad_mesh(z=2.5)])
    return np.asarray(data.positions), np.asarray(data.faces)


def bumpy(num_faces):
    mesh = jproc.bumpy_sphere_mesh(num_faces)
    faces = mesh.indices.reshape(-1, 3).astype(np.int32)
    return mesh.positions, np.concatenate(
        [faces, np.zeros((faces.shape[0], 1), np.int32)], axis=1)


# name: (scene, GridConfig keywords)
BUILD_CASES = {
    "mesh40": (lambda: _mesh(40, seed=11), {}),
    "mesh60": (lambda: _mesh(60, seed=12), {}),
    "bumpy3000": (lambda: bumpy(3000), {}),
    "bumpy3000_caps": (lambda: bumpy(3000),
                       dict(max_cells_per_face=4, num_cells=1024,
                            cell_res=0.05)),
    "config2_quad": (config2_scene, {}),
}


def builds(case):
    """JAX's grid and the port's on the same numpy scene."""
    scene, kw = BUILD_CASES[case]
    pos, faces = (np.asarray(x) for x in scene())
    jg = jgrid.build_grid(jnp.asarray(pos, jnp.float32),
                          jnp.asarray(faces, jnp.int32), JaxGridConfig(**kw))
    tg = tgrid.build_grid(torch.from_numpy(np.array(pos, np.float32)),
                          torch.from_numpy(faces.astype(np.int64)),
                          GridConfig(**kw))
    return jg, tg, faces.shape[0]


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_grid_matches_jax(case):
    jg, tg, num_faces = builds(case)
    assert tg.cell_start.dtype == tg.entries.dtype == torch.int32
    np.testing.assert_array_equal(tg.cell_start.numpy(),
                                  np.asarray(jg.cell_start))
    np.testing.assert_array_equal(tg.entries.numpy(), np.asarray(jg.entries))
    assert tg.num_cells == jg.num_cells
    assert float(tg.cell_res) == float(jg.cell_res)
    emitted = set(tg.entries[:int(tg.cell_start[-1])].tolist())
    if case.startswith("mesh"):  # every face overlaps its own cells
        assert emitted == set(range(num_faces))
    if case == "config2_quad":
        # The quad's two faces span ~100 x 67 cells; the build keeps the
        # first 64 candidates of each in x-fastest order, and of those the
        # SAT test keeps 64 and 1.
        kept = np.bincount(tg.entries[:int(tg.cell_start[-1])].numpy(),
                           minlength=num_faces)
        assert list(kept[-2:]) == [64, 1]


@pytest.mark.parametrize("case", ["mesh60", "config2_quad"])
def test_grid_stats_and_interop(case):
    """`grid_stats` and `accel_stats` give JAX's dict; a JAX grid carried
    over by `hash_grid_from_numpy` equals the port's build."""
    jg, tg, _ = builds(case)
    assert tstats.grid_stats(tg) == jstats.grid_stats(jg)
    assert tstats.accel_stats(tg) == jstats.accel_stats(jg)
    carried = interop.hash_grid_from_numpy(
        np.asarray(jg.cell_start), np.asarray(jg.entries),
        np.asarray(jg.cell_res), jg.num_cells, device="cpu")
    for name in ("cell_start", "entries", "cell_res"):
        got, want = getattr(carried, name), getattr(tg, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert carried.num_cells == tg.num_cells


def test_grid_stats_soup():
    """`tests/test_accel_stats.py:59`'s soup."""
    pos, faces = soup()
    jg = jgrid.build_grid(pos, faces, JaxGridConfig())
    tg = tgrid.build_grid(torch.from_numpy(np.array(pos)),
                          torch.from_numpy(np.array(faces, np.int64)))
    s = tstats.grid_stats(tg)
    assert s == jstats.grid_stats(jg)
    assert s["entries"] > 0 and s["live_cells"] <= s["cells"]
    assert s["faces_per_live_cell"]["min"] >= 1
