"""The port's brute-force tracer (`raytracercuda_torch.trace.bruteforce`,
kernel E's plain version on the CPU) against the JAX oracle
`trace_brute` and its Pallas form `trace_brute_pallas` (interpret mode),
on the random scenes of `tests/test_pallas_brute.py`.

Tolerances: face ids equal except near-ties (`assert_slots_match`: a
different winner only at a t within 1e-6 relative); on equal faces t
within 1e-5 relative and u, v within 5e-5 absolute, because XLA on the CPU
contracts multiply-adds and the port does not (`test_torch_sweep.py`
holds kernels A and C to the same bars).  The port itself is held bit-exact against the
oracle formula in numpy float32 on its winners, and its chunked sweep
bit-exact against one unchunked pass.  `any_hit_brute` masks are equal."""

import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, assert_slots_match

import jax.numpy as jnp

from raytracercuda_tpu.config import TraceConfig as JaxTraceConfig
from raytracercuda_tpu.trace import bruteforce as jbrute
from raytracercuda_tpu.trace.pallas_brute import trace_brute_pallas
from raytracercuda_tpu.types import FLT_MAX
from test_pallas_brute import rand_rays, rand_scene

from raytracercuda_torch.config import TraceConfig
from raytracercuda_torch.trace import bruteforce as tbrute


def mt_numpy(positions, faces, face, origin, direction):
    """t, u, v of each ray against the face it won, in numpy float32 with
    the oracle's terms (`ops/math.tri_intersect`), sums left to right."""
    f = faces[np.maximum(face, 0)]
    v0 = positions[f[:, 0]]
    e1 = positions[f[:, 1]] - v0
    e2 = positions[f[:, 2]] - v0
    d, o = direction, origin
    pv = np.stack([d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1],
                   d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2],
                   d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]], 1)
    det = e1[:, 0] * pv[:, 0] + e1[:, 1] * pv[:, 1] + e1[:, 2] * pv[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / det
    tv = o - v0
    u = (tv[:, 0] * pv[:, 0] + tv[:, 1] * pv[:, 1] + tv[:, 2] * pv[:, 2]) * inv
    qv = np.stack([tv[:, 1] * e1[:, 2] - tv[:, 2] * e1[:, 1],
                   tv[:, 2] * e1[:, 0] - tv[:, 0] * e1[:, 2],
                   tv[:, 0] * e1[:, 1] - tv[:, 1] * e1[:, 0]], 1)
    v = (d[:, 0] * qv[:, 0] + d[:, 1] * qv[:, 1] + d[:, 2] * qv[:, 2]) * inv
    t = (e2[:, 0] * qv[:, 0] + e2[:, 1] * qv[:, 1] + e2[:, 2] * qv[:, 2]) * inv
    return t, u, v


def run_port(positions, faces, origin, direction, clip=True):
    tbrute.reset_launch_counts()
    hit = tbrute.trace_brute(torch.from_numpy(positions),
                             torch.from_numpy(faces),
                             torch.from_numpy(origin),
                             torch.from_numpy(direction),
                             TraceConfig(clip_backward_hits=clip))
    assert tbrute.launch_counts["brute"] == 0  # CPU: the plain version
    assert hit.face.dtype == torch.int32 and hit.t.dtype == torch.float32
    return hit


# (faces, rays, seed, JAX Pallas block sizes, clip_backward_hits, origin
# shift).  The second case straddles the Pallas blocks, as
# test_pallas_brute's does; the third moves the origins into the cloud, so
# hits lie on both sides and clipping decides which side wins; the last
# puts face and ray counts one past kernel E's shapes (runs of 128 faces;
# 128 threads of 4 rays).
CASES = {
    "basic": (100, 333, 5, {}, True, 0.0),
    "padding_edges": (130, 70, 7, {"block_r": 64, "block_f": 128}, True,
                      0.0),
    "no_backward_clip": (60, 50, 11, {}, False, 4.0),
    "ragged_rays": (129, 513, 17, {}, True, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_brute_matches_jax(case, reference):
    num_faces, num_rays, seed, blocks, clip, shift = CASES[case]
    jpos, jfaces = rand_scene(num_faces, seed)
    jorg, jdir = rand_rays(num_rays, seed + 1)
    jorg = jorg + jnp.asarray([0.0, 0.0, shift], jnp.float32)
    jcfg = JaxTraceConfig(clip_backward_hits=clip)
    if reference == "xla":
        want = jbrute.trace_brute(jpos, jfaces, jorg, jdir, jcfg)
    else:
        want = trace_brute_pallas(jpos, jfaces, jorg, jdir, jcfg, **blocks)
    positions, faces = np.array(jpos), np.array(jfaces)
    origin, direction = np.array(jorg), np.array(jdir)
    got = run_port(positions, faces, origin, direction, clip)

    wf, gf = np.asarray(want.face), got.face.numpy()
    wt, gt = np.asarray(want.t), got.t.numpy()
    hit = wf >= 0
    np.testing.assert_array_equal(gf >= 0, hit)
    assert 0 < hit.sum() < hit.size
    assert_slots_match(gf, wf, gt, wt, max_share=0.02)
    same = hit & (gf == wf)
    assert_rel_close(gt, wt, same, rtol=1e-5)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[same],
                                   np.asarray(getattr(want, k))[same],
                                   rtol=0, atol=5e-5)
    # Misses: FLT_MAX, u = v = 0, face -1.
    assert (gt[~hit] == FLT_MAX).all()
    assert not got.u.numpy()[~hit].any() and not got.v.numpy()[~hit].any()
    # The port's values are the oracle formula's, rounded op by op.
    ref = mt_numpy(positions, faces, gf, origin, direction)
    for x, r in zip((gt, got.u.numpy(), got.v.numpy()), ref):
        np.testing.assert_array_equal(x[hit], r[hit])
    if not clip:
        assert (gt[hit] < 0).any()  # a backward hit won


def test_chunked_sweep_equals_one_pass(monkeypatch):
    """Rays and faces in chunks (strict `<` across face chunks) give what
    one pass gives, and a duplicated face ties to the first in face order
    even across a chunk boundary."""
    jpos, jfaces = rand_scene(90, 3)
    positions, faces = np.array(jpos), np.array(jfaces)
    # Faces 90-99 repeat faces 0-9: every ray that wins one of them ties.
    faces = np.concatenate([faces, faces[:10]])
    jorg, jdir = rand_rays(200, 4)
    origin, direction = np.array(jorg), np.array(jdir)
    whole = run_port(positions, faces, origin, direction)
    monkeypatch.setattr(tbrute, "_PLAIN_RAYS", 48)
    monkeypatch.setattr(tbrute, "_PLAIN_FACES", 32)
    chunked = run_port(positions, faces, origin, direction)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    face = chunked.face.numpy()
    assert ((face >= 0) & (face < 10)).any() and not (face >= 90).any()
    want = jbrute.trace_brute(jpos, jnp.asarray(faces), jorg, jdir)
    assert_slots_match(face, np.asarray(want.face), chunked.t.numpy(),
                       np.asarray(want.t), max_share=0.02)


@pytest.mark.parametrize("clip", [True, False])
def test_any_hit_brute_matches_jax(clip):
    jpos, jfaces = rand_scene(120, 21)
    jorg, jdir = rand_rays(300, 22)
    rng = np.random.default_rng(23)
    t_max = rng.uniform(0.5, 8.0, 300).astype(np.float32)
    want = np.asarray(jbrute.any_hit_brute(
        jpos, jfaces, jorg, jdir, t_max,
        JaxTraceConfig(clip_backward_hits=clip)))
    got = tbrute.any_hit_brute(
        torch.from_numpy(np.array(jpos)), torch.from_numpy(np.array(jfaces)),
        torch.from_numpy(np.array(jorg)), torch.from_numpy(np.array(jdir)),
        torch.from_numpy(t_max), TraceConfig(clip_backward_hits=clip))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_shared_origin_broadcasts():
    """A ``[3]`` origin is every ray's, as in the JAX oracle."""
    jpos, jfaces = rand_scene(80, 31)
    _, jdir = rand_rays(64, 32)
    eye = np.array([0.0, 0.0, -4.0], np.float32)
    positions, faces = np.array(jpos), np.array(jfaces)
    direction = np.array(jdir)
    shared = run_port(positions, faces, eye, direction)
    rows = run_port(positions, faces, np.tile(eye, (64, 1)), direction)
    for a, b in zip(shared, rows):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = jbrute.trace_brute(jpos, jfaces, eye, jdir)
    np.testing.assert_array_equal(np.asarray(want.face), shared.face.numpy())


def test_cuda_wrapper_rejects_cpu_tensors():
    tris = torch.zeros((9, 4))
    rays = torch.zeros((8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tbrute._brute_cuda(rays, rays, tris, np.float32(1e-4))
