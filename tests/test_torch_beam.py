"""The port's tile-beam traversal (`raytracercuda_torch.trace.beam`: kernel
L's plain version, and `occlusion_beam`) against the JAX package's
`trace_beam` and `occlusion_beam` on the CPU, on the random triangle
clouds of `tests/test_beam.py`.

Tolerances, stated per check:

  * face ids equal to JAX's, and to the port's own per-ray walk (the beam
    is exact, not an approximation), apart from the JAX package's slot
    rule for trees without traversal leaves
    (`test_trace_beam_matches_walk`);
  * t, u and v within 1e-5 relative and 5e-5 absolute (XLA on the CPU
    contracts multiply-adds; the port does not);
  * occlusion masks equal.
"""

import numpy as np
import pytest
import torch

from test_torch_bvh import assert_hits_match, big_triangles, random_mesh

import jax.numpy as jnp

from raytracercuda_tpu.accel.bvh import build_bvh as jax_build
from raytracercuda_tpu.config import BvhConfig as JaxBvhConfig
from raytracercuda_tpu.models.camera import camera_ray_grid
from raytracercuda_tpu.trace.beam import occlusion_beam as jax_occlusion
from raytracercuda_tpu.trace.beam import trace_beam as jax_beam

from raytracercuda_torch.accel.bvh import build_bvh
from raytracercuda_torch.config import BvhConfig
from raytracercuda_torch.models.camera import orient_from_pan_pitch
from raytracercuda_torch.trace import beam, traverse

def doubled(mesh):
    """Every face of ``mesh`` twice, on the same vertices: each hit is an
    exact-t tie between a face and its copy."""
    verts, faces = mesh
    return verts, np.concatenate([faces, faces])


# name: (mesh, max_leaf_faces, frame side, tile_px, queue, eye, (pan,
# pitch))
BEAM_CASES = {
    "f120_tile8": (lambda: random_mesh(120, 31), 4, 32, 8, 128, None, None),
    "f120_queue4_overflow": (lambda: random_mesh(120, 32), 4, 32, 8, 4,
                             None, None),
    "f60_tile16": (lambda: random_mesh(60, 34), 16, 32, 16, 128, None, None),
    "f300_leaf16_64px": (lambda: random_mesh(300, 3), 16, 64, 16, 128, None,
                         None),
    "f200_leaf1_queue4": (lambda: random_mesh(200, 35), 1, 32, 8, 4, None,
                          None),
    "f120_tile2": (lambda: random_mesh(120, 37), 4, 16, 2, 128, None, None),
    "single_leaf_tree": (lambda: big_triangles(1), 16, 16, 8, 4, None, None),
    "two_faces": (lambda: big_triangles(2), 16, 32, 8, 128, None, None),
    "offset_eye_rotated": (lambda: random_mesh(100, 36), 16, 32, 16, 128,
                           (0.5, -0.3, 0.2), (0.4, -0.25)),
    "f60_doubled_ties": (lambda: doubled(random_mesh(60, 34)), 4, 32, 8, 16,
                         None, None),
}


@pytest.fixture(scope="module")
def frames():
    """name: (JAX `Hit`, port `Hit`, port per-ray walk `Hit`, inputs)."""
    out = {}
    for name, (mesh, leaf, side, tile_px, queue, eye, pose) in \
            BEAM_CASES.items():
        verts, faces = mesh()
        dirs = np.array(camera_ray_grid(side, side))
        if pose is not None:
            orient = orient_from_pan_pitch(*pose).astype(np.float32)
            dirs = (dirs @ orient.T).astype(np.float32)
        eye = np.zeros(3, np.float32) if eye is None else np.asarray(
            eye, np.float32)
        jb = jax_build(jnp.asarray(verts), jnp.asarray(faces),
                       JaxBvhConfig(max_leaf_faces=leaf))
        want = jax_beam(jb, jnp.asarray(eye), jnp.asarray(dirs), side, side,
                        tile_px, queue, JaxBvhConfig(max_leaf_faces=leaf))
        cfg = BvhConfig(max_leaf_faces=leaf)
        tb = build_bvh(torch.from_numpy(verts),
                       torch.from_numpy(faces.astype(np.int64)), cfg)
        te, td = torch.from_numpy(eye), torch.from_numpy(dirs)
        got = beam.trace_beam(tb, te, td, side, side, tile_px, queue, cfg)
        walk = traverse.trace_bvh(tb, None, None, te, td, cfg)
        out[name] = (want, got, walk, (jb, tb, eye, dirs, side, cfg))
    return out


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_trace_beam_matches_jax(frames, case):
    want, got, _, _ = frames[case]
    assert got.face.dtype == torch.int32
    assert_hits_match(got, want)


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_trace_beam_matches_walk(frames, case):
    """The beam finds each pixel's closest hit: the triangle the per-ray
    walk finds, at the same t, u and v (both sides test the same row with
    the same arithmetic).

    The face ids are equal too, except in a tree that the leaf collapse
    left without traversal leaves (two faces, ``max_leaf_faces`` 16): its
    Karras leaves carry the a-link -1, ``first = -1``, and the JAX
    package's beam test reads row ``k`` of such an entry but records slot
    ``clip(k - 1)``.  The port keeps that rule (the faces equal JAX's
    above), so a hit on slot 1's triangle reports slot 0's face."""
    _, got, walk, (_, tb, _, _, _, _) = frames[case]
    for name in ("t", "u", "v"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(walk, name).numpy())
    face, want = got.face.numpy(), walk.face.numpy()
    if case == "two_faces":
        order = tb.face_order.numpy()
        assert not tb.is_leaf.any()
        moved = want == order[1]
        assert moved.any()
        np.testing.assert_array_equal(face[moved], order[0])
        face, want = face[~moved], want[~moved]
    np.testing.assert_array_equal(face, want)


def test_trace_beam_default_frame_and_errors(frames):
    """A square frame infers its size; a tile that does not divide the
    frame, or a frame that is not square without its size, raises."""
    _, got, _, (_, tb, eye, dirs, side, cfg) = frames["f120_tile8"]
    again = beam.trace_beam(tb, torch.from_numpy(eye),
                            torch.from_numpy(dirs), tile_px=8, queue=128,
                            cfg=cfg)
    np.testing.assert_array_equal(again.face.numpy(), got.face.numpy())
    with pytest.raises(ValueError, match="not divisible"):
        beam.trace_beam(tb, torch.from_numpy(eye), torch.from_numpy(dirs),
                        side, side, tile_px=12, cfg=cfg)
    with pytest.raises(ValueError, match="height and width"):
        beam.trace_beam(tb, torch.from_numpy(eye),
                        torch.from_numpy(dirs[:-side]), cfg=cfg)


# name: (beam case, share of active rays, light)
OCCLUSION_CASES = {
    "f120_tile8": ("f120_tile8", 0.6, (0.3, 0.8, -0.5)),
    "f300_leaf16": ("f300_leaf16_64px", 0.5, (-0.2, 0.9, -0.3)),
    "no_active_rays": ("f120_tile8", 0.0, (0.3, 0.8, -0.5)),
}


@pytest.mark.parametrize("case", sorted(OCCLUSION_CASES))
def test_occlusion_beam_matches_jax(frames, case):
    name, share, light = OCCLUSION_CASES[case]
    _, _, _, (jb, tb, _, _, side, cfg) = frames[name]
    rng = np.random.default_rng(41)
    origins = rng.uniform(-1.5, 1.5, (side * side, 3)).astype(np.float32)
    origins[:, 2] += 3.0
    active = rng.random(side * side) < share
    light = np.asarray(light, np.float32) / np.linalg.norm(light)
    want = np.asarray(jax_occlusion(
        jb, jnp.asarray(origins), jnp.asarray(light), jnp.asarray(active),
        side, side, 8, 16, JaxBvhConfig(max_leaf_faces=cfg.max_leaf_faces)))
    got = beam.occlusion_beam(tb, torch.from_numpy(origins),
                              torch.from_numpy(light),
                              torch.from_numpy(active), side, side, 8, 16,
                              cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    if share:
        assert 0 < want.sum() < active.sum()
    else:
        assert not want.any()
