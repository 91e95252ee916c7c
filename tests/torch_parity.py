"""Shared pieces of the parity tests between `raytracercuda_torch` and the
JAX package: one numpy scene feeds both sides, JAX runs its Pallas
kernels in interpret mode, the port runs its kernels' plain versions on
the CPU.

Importing this module checks that the port's sources never import jax,
before any test file imports the port.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

import numpy as np
import torch

# Tier-1 runs several pytest workers on a few cores; torch's default of
# one thread per core would oversubscribe them.
torch.set_num_threads(1)

PORT_DIR = pathlib.Path(__file__).resolve().parent.parent / "raytracercuda_torch"
_JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)


def port_files_importing_jax() -> list[str]:
    """The port's ``.py`` sources that import jax (should be none)."""
    return sorted(str(p.relative_to(PORT_DIR))
                  for p in PORT_DIR.rglob("*.py")
                  if _JAX_IMPORT.search(p.read_text()))


_offenders = port_files_importing_jax()
if _offenders:
    raise ImportError(f"raytracercuda_torch imports jax in {_offenders}")

import jax.numpy as jnp  # noqa: E402

from raytracercuda_tpu.config import AccelKind, RenderConfig  # noqa: E402
from raytracercuda_tpu.models.scene import SceneData as JaxSceneData  # noqa: E402

from raytracercuda_torch import interop  # noqa: E402
from raytracercuda_torch.config import AccelKind as TorchAccelKind  # noqa: E402
from raytracercuda_torch.config import RenderConfig as TorchRenderConfig  # noqa: E402
from test_frame import make_scene  # noqa: E402

SIDE = 64  # frame edge in pixels: 16 tiles of 16x16


def numpy_scene(num_faces: int = 900, seed: int = 17, uv: bool = False,
                textured: bool = False) -> dict:
    """`test_frame.make_scene`'s scene as numpy fields.  ``uv`` adds random
    vertex uvs (some outside [0, 1), so wrap addressing runs); ``textured``
    also gives the material texture 0, a random 8x8 texture."""
    fields = {k: v for k, v in make_scene(num_faces, seed)._asdict().items()}
    fields = {k: ({s: np.array(a) for s, a in v.items()}
                  if isinstance(v, dict) else
                  None if v is None else np.array(v))
              for k, v in fields.items()}
    rng = np.random.default_rng(seed + 1000)
    nv = fields["positions"].shape[0]
    if uv or textured:
        fields["attrs"][2] = (rng.random((nv, 2)) * 3.0 - 1.0).astype(
            np.float32)
    if textured:
        fields["texture_id"] = np.array([0], np.int32)
        fields["textures"] = rng.random((1, 8, 8, 3)).astype(np.float32)
    return fields


def jax_scene(fields: dict) -> JaxSceneData:
    return JaxSceneData(**{
        k: ({s: jnp.asarray(a) for s, a in v.items()}
            if isinstance(v, dict) else None if v is None else jnp.asarray(v))
        for k, v in fields.items()})


def torch_scene(fields: dict):
    return interop.scene_from_numpy(**fields)


def torch_clusters(cs):
    """The port's `ClusterSet` from a JAX `ClusterSet`."""
    return interop.cluster_set_from_numpy(
        np.asarray(cs.cmin), np.asarray(cs.cmax), np.asarray(cs.tris),
        np.asarray(cs.face_order), np.asarray(cs.face_rank))


def jax_config(list_width: int = 32) -> RenderConfig:
    """CLUSTER config that forces the Pallas sweep (interpret mode on the
    CPU; the auto setting picks the XLA path there)."""
    base = RenderConfig(accel=AccelKind.CLUSTER)
    return dataclasses.replace(base, trace=dataclasses.replace(
        base.trace, use_pallas_sweep=True, sweep_list_width=list_width))


def torch_config():
    return TorchRenderConfig(accel=TorchAccelKind.CLUSTER)


def assert_slots_match(slot_a, slot_b, t_a, t_b, max_share=1e-3,
                       rtol=1e-6) -> int:
    """Slots equal, except near-ties: pixels whose two winning t values lie
    within ``rtol`` of each other, at most ``max_share`` of the pixels.
    Returns the number of near-tie pixels."""
    slot_a, slot_b = np.asarray(slot_a).ravel(), np.asarray(slot_b).ravel()
    t_a, t_b = np.asarray(t_a).ravel(), np.asarray(t_b).ravel()
    diff = slot_a != slot_b
    close = np.abs(t_a - t_b) <= rtol * np.maximum(np.abs(t_a), np.abs(t_b))
    assert (close | ~diff).all(), (
        f"{int((diff & ~close).sum())} pixels pick another winner at a "
        f"different t")
    n = int(diff.sum())
    print(f"near-tie slot differences: {n} of {diff.size} pixels")
    assert n <= max_share * diff.size
    return n


def assert_u8_close(packed_a, packed_b, atol: int = 1) -> None:
    """Packed 0x00RRGGBB frames agree within ``atol`` per u8 channel."""
    a = np.asarray(packed_a).astype(np.int64)
    b = np.asarray(packed_b).astype(np.int64)
    assert a.shape == b.shape
    for shift in (16, 8, 0):
        ca, cb = (a >> shift) & 0xFF, (b >> shift) & 0xFF
        assert np.abs(ca - cb).max() <= atol, f"channel <<{shift} differs"


def assert_rel_close(a, b, mask, rtol: float = 1e-6) -> None:
    """``a`` and ``b`` within ``rtol`` relative where ``mask``."""
    a, b = np.asarray(a)[mask], np.asarray(b)[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
