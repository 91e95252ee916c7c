"""Kernel E's synthetic cases (`chip_smoke.brute_case_inputs`: a face copied
across the kernel's face-chunk boundary, backward hits from inside a mesh,
t = +-0.0 ties at mesh vertices, degenerate faces, ray and face counts off
the kernel's block shapes, a single ray) through the port's plain version
(`trace_brute` on CPU tensors), against an all-pairs numpy float32
transcription of the oracle and against the JAX oracle `trace_brute` and
its Pallas form `trace_brute_pallas` (interpret mode).  These pin the
oracle's rules that the kernel must keep; on the card `chip_smoke.py`
holds the kernel bit-equal to the plain version on the same cases.

Tolerances: against numpy, faces equal and t, u, v bit-equal (both round
each operation on its own).  Against JAX, XLA on the CPU contracts
multiply-adds and the port does not (`test_torch_brute.py` holds the
oracle's random scenes to the same bars): faces equal, except for rays
from a vertex whose winner in one of the two lies at |t| <= 1e-5 (the
faces around the vertex meet the ray at t = +-0 with u or v = +-0, and
contraction decides whether one rounds below zero); on equal faces t
within 1e-5 relative, or 1e-6 absolute near t = 0, and u, v within 5e-5
absolute; misses carry FLT_MAX, u = v = 0 and face -1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracercuda_tpu.config import TraceConfig as JaxTraceConfig
from raytracercuda_tpu.trace import bruteforce as jbrute
from raytracercuda_tpu.trace.pallas_brute import trace_brute_pallas
from raytracercuda_tpu.types import FLT_MAX

from chip_smoke import brute_case_inputs, check_brute_case

from raytracercuda_torch.config import TraceConfig
from raytracercuda_torch.trace import bruteforce as tbrute

CHUNK = tbrute.BRUTE_FACE_CHUNK
CASES = brute_case_inputs(CHUNK)


def run_port(pos, faces, origin, direction, clip):
    tbrute.reset_launch_counts()
    hit = tbrute.trace_brute(torch.from_numpy(pos), torch.from_numpy(faces),
                             torch.from_numpy(origin),
                             torch.from_numpy(direction),
                             TraceConfig(clip_backward_hits=clip))
    assert tbrute.launch_counts["brute"] == 0  # CPU: the plain version
    return hit


def run_jax(pos, faces, origin, direction, clip, reference):
    jfaces = jnp.asarray(np.concatenate(
        [faces, np.zeros((len(faces), 1), np.int64)], 1).astype(np.int32))
    args = (jnp.asarray(pos), jfaces, jnp.asarray(origin),
            jnp.asarray(direction), JaxTraceConfig(clip_backward_hits=clip))
    if reference == "xla":
        return jbrute.trace_brute(*args)
    return trace_brute_pallas(*args)


def numpy_oracle(pos, faces, origin, direction, clip):
    """All pairs in numpy float32, `tri_intersect`'s terms with each sum
    left to right, the NaN miss rule, the first minimum in face order:
    (t, u, v, face)."""
    v0 = pos[faces[:, 0]]
    e1 = pos[faces[:, 1]] - v0
    e2 = pos[faces[:, 2]] - v0
    out = []
    for r0 in range(0, len(direction), 256):
        o = origin[r0:r0 + 256, :, None]
        d = direction[r0:r0 + 256, :, None]
        with np.errstate(all="ignore"):
            pv = [d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1],
                  d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2],
                  d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]]
            det = e1[:, 0] * pv[0] + e1[:, 1] * pv[1] + e1[:, 2] * pv[2]
            inv = np.float32(1.0) / det
            tv = [o[:, k] - v0[:, k] for k in range(3)]
            u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv
            qv = [tv[1] * e1[:, 2] - tv[2] * e1[:, 1],
                  tv[2] * e1[:, 0] - tv[0] * e1[:, 2],
                  tv[0] * e1[:, 1] - tv[1] * e1[:, 0]]
            v = (d[:, 0] * qv[0] + d[:, 1] * qv[1] + d[:, 2] * qv[2]) * inv
            t = (e2[:, 0] * qv[0] + e2[:, 1] * qv[1] + e2[:, 2] * qv[2]) * inv
            miss = ((u < 0) | (u > 1) | (v < 0) | (u + v > 1) | np.isnan(u)
                    | np.isnan(v) | np.isnan(t))
            t = np.where(miss, np.float32(FLT_MAX), t)
            if clip:
                t = np.where(t < np.float32(1e-4), np.float32(FLT_MAX), t)
        j = t.argmin(axis=1)  # the first minimum
        rows = np.arange(len(j))
        bt = t[rows, j]
        hit = bt < np.float32(FLT_MAX)
        out.append((bt, np.where(hit, u[rows, j], 0), np.where(hit, v[rows, j],
                                                               0),
                    np.where(hit, j, -1)))
    return [np.concatenate(x) for x in zip(*out)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_brute_cases_match_numpy_oracle(case):
    pos, faces, origin, direction, clip = CASES[case]
    got = run_port(pos, faces, origin, direction, clip)
    want = numpy_oracle(pos, faces, origin, direction, clip)
    np.testing.assert_array_equal(got.face.numpy(), want[3])
    for g, w in zip((got.t, got.u, got.v), want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.astype(np.float32).view(np.int32))
    miss = want[3] < 0
    assert (got.t.numpy()[miss] == FLT_MAX).all()
    check_brute_case(case, CHUNK, got.face, got.t)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_brute_cases_match_jax(case, reference):
    pos, faces, origin, direction, clip = CASES[case]
    got = run_port(pos, faces, origin, direction, clip)
    want = run_jax(pos, faces, origin, direction, clip, reference)
    gf, wf = got.face.numpy(), np.asarray(want.face)
    gt, wt = got.t.numpy(), np.asarray(want.t)
    hit = wf >= 0
    differ = gf != wf
    if case == "vertex_ties":
        # A ray from a vertex meets the faces around it at t = +-0 with u
        # or v = +-0; contraction decides whether one rounds below zero.
        at_vertex = np.minimum(np.abs(gt), np.abs(wt)) <= 1e-5
        assert (at_vertex | ~differ).all(), (
            f"{int((differ & ~at_vertex).sum())} rays")
        assert (~differ & ~at_vertex).any()
    else:
        np.testing.assert_array_equal(gf, wf)
    same = hit & ~differ
    np.testing.assert_allclose(gt[same], wt[same], rtol=1e-5, atol=1e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[same],
                                   np.asarray(getattr(want, k))[same],
                                   rtol=0, atol=5e-5)
    miss = gf < 0
    assert (gt[miss] == FLT_MAX).all()
    assert not got.u.numpy()[miss].any() and not got.v.numpy()[miss].any()


def test_face_chunk_boundary(monkeypatch):
    """With the plain version's face chunks cut where the kernel's are, a
    face and its copy one past the boundary tie, and the earlier face wins
    across the boundary, as it does in one pass and in the oracle."""
    pos, faces, origin, direction, clip = CASES["duplicate_across_chunk"]
    whole = run_port(pos, faces, origin, direction, clip)
    monkeypatch.setattr(tbrute, "_PLAIN_FACES", CHUNK)
    chunked = run_port(pos, faces, origin, direction, clip)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    face = chunked.face.numpy()
    assert (face == CHUNK - 1).any() and not (face == CHUNK).any()
    want = run_jax(pos, faces, origin, direction, clip, "xla")
    np.testing.assert_array_equal(face, np.asarray(want.face))
