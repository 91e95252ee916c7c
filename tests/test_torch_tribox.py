"""The port's separating-axis triangle/box test (`ops/tribox.py`) against
the JAX package's, on the CPU: the six cases of `tests/test_tribox.py`, a
random batch, and every (face, candidate cell) pair of a 3,000-face
bumpy sphere's grid build, which holds a pair that only the fused
multiply-add rounding of XLA on the CPU puts inside its box.  JAX's test
runs compiled (``jax.jit``), as `build_grid` runs it.  The bar is exact:
equal booleans.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (checks the port imports no jax first)
from test_tribox import ref_sat

import jax
import jax.numpy as jnp

from raytracercuda_tpu.models import procedural as jproc
from raytracercuda_tpu.ops.tribox import tri_box_overlap as jax_overlap

from raytracercuda_torch.ops import math as tmath
from raytracercuda_torch.ops import tribox as ttribox
from raytracercuda_torch.ops.tribox import tri_box_overlap

# name: (center, half, t0, t1, t2, expected) from tests/test_tribox.py.
CASES = {
    "inside": ([0, 0, 0], [1, 1, 1], [-0.5, -0.5, 0], [0.5, -0.5, 0],
               [0, 0.5, 0], True),
    "outside": ([0, 0, 0], [1, 1, 1], [2, 2, 2], [3, 2, 2], [2, 3, 2],
                False),
    "plane_separates": ([0, 0, 0], [0.1, 0.1, 0.1], [1, -1, 1.5],
                        [-1, 1, 1.5], [1, 1, 1.5], False),
    "pierces_face": ([0, 0, 0], [1, 1, 1], [0, 0, -2], [0, 0, 2],
                     [0.1, 0.1, 0], True),
}


def both(*arrays):
    """The port's and JAX's answers on the same float32 inputs."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    got = tri_box_overlap(*(torch.from_numpy(a) for a in arrays)).numpy()
    want = np.asarray(jax.jit(jax_overlap)(*(jnp.asarray(a)
                                             for a in arrays)))
    return got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_case(name):
    *args, expected = CASES[name]
    got, want = both(*args)
    assert got.shape == () and bool(got) == bool(want) == expected


def test_randomized_vs_jax_and_scalar_sat():
    rng = np.random.default_rng(7)
    n = 500
    center = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    half = rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32)
    tri = rng.uniform(-2, 2, (n, 3, 3)).astype(np.float32)
    got, want = both(center, half, tri[:, 0], tri[:, 1], tri[:, 2])
    np.testing.assert_array_equal(got, want)
    ref = np.array([ref_sat(center[i], half[i], *tri[i]) for i in range(n)])
    np.testing.assert_array_equal(got, ref)
    assert ref.sum() > 20 and (~ref).sum() > 20


def test_batched_shapes():
    """Broadcast operands: four boxes against one triangle."""
    got, want = both(np.zeros((4, 3)), np.ones((4, 3)), [0, 0, 0], [1, 0, 0],
                     [0, 1, 0])
    assert got.shape == (4,) and got.all() and want.all()


def test_grid_build_pairs_vs_jax(monkeypatch):
    """Every candidate (face, cell) pair of `build_grid` on a 3,000-face
    bumpy sphere (64 cells a face, 0.03 cells): equal to JAX's, including
    a pair that a triangle touches within a rounding error: rounded
    without fused multiply-adds, face 125 misses its 12th cell."""
    mesh = jproc.bumpy_sphere_mesh(3000)
    tris = mesh.positions[mesh.indices.reshape(-1, 3)]  # [F, 3, 3]
    res, inv = np.float32(0.03), np.float32(1.0) / np.float32(0.03)
    c0 = np.floor(tris.min(axis=1) * inv).astype(np.int32)
    dims = np.floor(tris.max(axis=1) * inv).astype(np.int32) - c0 + 1
    k = np.arange(64)[None, :]
    nx, ny = dims[:, 0:1], dims[:, 1:2]
    cell = np.stack([c0[:, 0:1] + k % nx, c0[:, 1:2] + (k // nx) % ny,
                     c0[:, 2:3] + k // (nx * ny)], axis=-1)
    bmin = cell.astype(np.float32) * res
    bmax = bmin + res
    args = ((bmin + bmax) * np.float32(0.5), (bmax - bmin) * np.float32(0.5),
            tris[:, None, 0], tris[:, None, 1], tris[:, None, 2])
    got, want = both(*args)
    valid = k < dims.prod(axis=1)[:, None]
    np.testing.assert_array_equal(got[valid], want[valid])
    assert want[125, 12] and valid[125, 12]
    assert 0.05 < got[valid].mean() < 0.95
    one = [np.array(np.broadcast_to(a, cell.shape)[125, 12]) for a in args]
    for module in (tmath, ttribox):
        monkeypatch.setattr(module, "fma32", lambda a, b, c: a * b + c)
    assert not bool(tri_box_overlap(*(torch.from_numpy(a) for a in one)))
