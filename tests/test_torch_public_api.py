"""The port's public API against the JAX package's, on the CPU: every
top-level name of `raytracercuda_tpu` exists in `raytracercuda_torch`
with an equal value where it is a constant (error codes, vertex-data
slots, FLT_MAX, the version; `types.py`'s sentinels) and equal fields and defaults where it is a
configuration class; `Rays`, `miss_hit`, `SceneData`'s helpers and the
small helpers of `ops/math.py` hold JAX's values exactly on the cases of
`tests/test_math.py:138-155`.
"""

import dataclasses
import enum
import types

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (checks the port imports no jax first)

import jax.numpy as jnp

import raytracercuda_tpu as jrt
from raytracercuda_tpu import types as jtypes
from raytracercuda_tpu.models import procedural as jproc
from raytracercuda_tpu.ops import math as jm

import raytracercuda_torch as trt
from raytracercuda_torch import types as ttypes
from raytracercuda_torch.models import procedural as tproc
from raytracercuda_torch.ops import math as tm

# The JAX package's exports (its submodules, which appear as attributes
# once imported, are not).
JAX_NAMES = sorted(n for n in dir(jrt) if not n.startswith("_")
                   and not isinstance(getattr(jrt, n), types.ModuleType))


def _constant(x) -> bool:
    return isinstance(x, (int, float, str, np.generic))


@pytest.mark.parametrize("name", JAX_NAMES)
def test_top_level_name(name):
    """The port exports the name; a constant has JAX's value, a config
    class JAX's fields and defaults, an enum JAX's members."""
    assert hasattr(trt, name), name
    want, got = getattr(jrt, name), getattr(trt, name)
    if _constant(want):
        assert type(got) is type(want) and got == want
    elif isinstance(want, type) and issubclass(want, enum.Enum):
        assert [(m.name, m.value) for m in got] == [(m.name, m.value)
                                                    for m in want]
    elif isinstance(want, type) and dataclasses.is_dataclass(want):
        assert repr(got()) == repr(want())
    elif dataclasses.is_dataclass(want):  # DEFAULT_CONFIG
        assert repr(got) == repr(want)
    elif isinstance(want, type) and hasattr(want, "_fields"):
        assert got._fields == want._fields


def test_version_and_all():
    assert trt.__version__ == jrt.__version__
    assert set(JAX_NAMES) <= set(trt.__all__)
    assert all(hasattr(trt, n) for n in trt.__all__)
    assert trt.DEFAULT_CONFIG == trt.RenderConfig()
    err = trt.BeamError(trt.ERROR_INVALID_FORMAT, "bad")
    assert err.code == 4 and str(err) == str(jrt.BeamError(4, "bad"))


@pytest.mark.parametrize("name", ["FLT_MAX", "INVALID_U32", "INVALID_I32"])
def test_types_sentinel(name):
    """`types.py`'s sentinels: JAX's value and numpy scalar type."""
    want, got = getattr(jtypes, name), getattr(ttypes, name)
    assert type(got) is type(want) and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_rays_and_miss_hit():
    o, d = torch.zeros(4, 3), torch.ones(4, 3)
    rays = trt.Rays(o, d)
    assert rays.origin is o and rays.direction is d
    got = ttypes.miss_hit((2, 3), device="cpu")
    want = jtypes.miss_hit((2, 3))
    assert isinstance(got, trt.Hit)
    for name in trt.Hit._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape and g.dtype == {
            np.float32: torch.float32, np.int32: torch.int32}[w.dtype.type]
        np.testing.assert_array_equal(g.numpy(), w)
    assert not got.hit_mask.any()


def test_scene_data_helpers():
    """`num_vertices`, `face_vertices` and `aabb` of one flattened scene."""
    td = trt.flatten_meshes([tproc.bumpy_sphere_mesh(300, seed=2),
                             tproc.quad_mesh(z=2.5)], device="cpu")
    jd = jrt.flatten_meshes([jproc.bumpy_sphere_mesh(300, seed=2),
                             jproc.quad_mesh(z=2.5)])
    assert td.num_vertices == jd.num_vertices
    ids = np.array([[0, 5], [td.num_faces - 1, 7]])
    for g, w in zip(td.face_vertices(torch.from_numpy(ids)),
                    jd.face_vertices(jnp.asarray(ids))):
        assert tuple(g.shape) == (2, 2, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(td.aabb(), jd.aabb()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_helpers():
    """`pack_gray` and `pack_rgb_vec` on `tests/test_math.py`'s cases: the
    CUDA path's truncation, and the unpack round trip."""
    for x in (0.5, 0.0, 1.0, -0.2, 1.7, 0.999):
        got = tm.pack_gray(torch.tensor(x))
        assert int(got) == int(jm.pack_gray(jnp.float32(x)))
    assert int(tm.pack_gray(torch.tensor(0.5))) == (127 << 16) | (127 << 8) \
        | 127
    vals = np.array([0x00FF8040, 0x00000000, 0x00FFFFFF], np.uint32)
    got = tm.pack_rgb_vec(tm.unpack_rgb(torch.from_numpy(vals)))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), vals)
    rgb = np.random.default_rng(3).uniform(-0.5, 1.5, (64, 3)).astype(
        np.float32)
    got = tm.pack_rgb_vec(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jm.pack_rgb_vec(jnp.asarray(rgb)))
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_aabb_helpers():
    """`aabb_overlap` (touching boxes overlap) and `validate_aabb` on the
    JAX tests' cases and a random batch."""
    t = torch.tensor
    amin, amax = t([0.0, 0, 0]), t([1.0, 1, 1])
    assert bool(tm.aabb_overlap(amin, amax, t([0.5, 0.5, 0.5]),
                                t([2.0, 2, 2])))
    assert not bool(tm.aabb_overlap(amin, amax, t([1.5, 0.0, 0.0]),
                                    t([2.0, 1, 1])))
    assert bool(tm.aabb_overlap(amin, amax, t([1.0, 0.0, 0.0]),
                                t([2.0, 1, 1])))
    rng = np.random.default_rng(4)
    a0, b0 = (rng.uniform(-1, 1, (256, 3)).astype(np.float32)
              for _ in range(2))
    a1 = a0 + rng.uniform(-0.2, 1, (256, 3)).astype(np.float32)
    b1 = b0 + rng.uniform(-0.2, 1, (256, 3)).astype(np.float32)
    got = tm.aabb_overlap(*(torch.from_numpy(x) for x in (a0, a1, b0, b1)))
    want = jm.aabb_overlap(*(jnp.asarray(x) for x in (a0, a1, b0, b1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < 256
    got = tm.validate_aabb(torch.from_numpy(a0), torch.from_numpy(a1))
    want = jm.validate_aabb(jnp.asarray(a0), jnp.asarray(a1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool(tm.validate_aabb(t([1.0, 1, 1]), t([0.0, 0, 0])))
    assert bool(tm.validate_aabb(t([1.0, 0, 1]), t([0.0, 0, 0])))
