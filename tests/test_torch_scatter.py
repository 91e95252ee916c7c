"""Kernel G's plain version (`raytracercuda_torch.diff.scatter`) against
the JAX package's `tile_scatter_add` in Pallas interpret mode, on the
cases of `tests/test_scatter.py` plus JAX's branch for more strays than
``stray_cap``; and `gather_rows_tiled`'s backward against plain
autograd."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (checks the port imports no jax)

import jax.numpy as jnp

import raytracercuda_tpu.diff.scatter as jscatter
from raytracercuda_tpu.ops import pallas_util

from raytracercuda_torch.diff import scatter as tscatter


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    # As in tests/test_scatter.py: run the Pallas kernel interpreted.
    monkeypatch.setattr(pallas_util, "interpret_mode", lambda: True)
    monkeypatch.setattr(jscatter, "interpret_mode", lambda: True)
    yield


def _coherent(rng, t, b, f):
    centers = rng.integers(0, f - 320, t)
    return centers[:, None] + rng.integers(0, 300, (t, b))


def _bimodal(rng, t, b, f):
    return np.concatenate([rng.integers(0, 300, (t, b // 2)),
                           rng.integers(6000, 6300, (t, b // 2))], axis=1)


def _with_misses(rng, t, b, f):
    ids = _coherent(rng, t, b, f)
    return np.where(rng.random((t, b)) < 0.3, -1, ids)


# name: (tiles, rays, cols, rows, id maker, JAX window, windows, stray_cap)
SCATTER_CASES = {
    "windowed": (4, 256, 12, 1024, _coherent, 512, 1, 16384),
    "strays": (3, 128, 8, 2048,
               lambda rng, t, b, f: rng.integers(0, f, (t, b)), 256, 1,
               16384),
    "misses_to_row0": (2, 128, 4, 512,
                       lambda rng, t, b, f: rng.integers(-1, 40, (t, b)),
                       128, 1, 16384),
    "bimodal": (4, 256, 16, 8192, _bimodal, 512, 2, 16384),
    # More strays than the cap: JAX's full segment_sum branch, which its
    # own tests never reach.
    "over_stray_cap": (3, 128, 8, 2048,
                       lambda rng, t, b, f: rng.integers(0, f, (t, b)), 256,
                       1, 16),
    # Kernel G's widths on config 4's path, over row counts that are not a
    # multiple of 4 (its fill's scalar tail), with misses: 22 columns (face
    # rows without uvs, float2 atomics) and 28 (with uvs, float4).
    "d22_ragged_rows": (3, 256, 22, 1001, _with_misses, 512, 1, 16384),
    "d28_ragged_rows": (4, 256, 28, 2051, _with_misses, 512, 2, 16384),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_tile_scatter_add_matches_jax(case):
    t, b, d, f, make_ids, window, n_windows, cap = SCATTER_CASES[case]
    rng = np.random.default_rng(sorted(SCATTER_CASES).index(case))
    idx = make_ids(rng, t, b, f).astype(np.int32)
    g = rng.normal(size=(t, d, b)).astype(np.float32)
    if case == "misses_to_row0":
        # The gather's backward credits misses to row 0 (as
        # tests/test_scatter.py does, JAX gets the clamped ids).
        idx = np.maximum(idx, 0)
    base = jscatter.tile_bases(jnp.asarray(idx), window, n_windows)
    covered = np.zeros(idx.shape, bool)
    for k in range(n_windows):
        bk = np.asarray(base)[:, k:k + 1]
        covered |= (bk >= 0) & (idx >= bk) & (idx < bk + window)
    strays = int(((idx >= 0) & ~covered).sum())
    if case == "strays":
        assert 0 < strays <= cap  # JAX's compacted fallback
    elif case == "over_stray_cap":
        assert strays > cap  # JAX's full fallback
    want = np.asarray(jscatter.tile_scatter_add(
        jnp.asarray(g), jnp.asarray(idx), base, f, window=window, chunk=128,
        stray_cap=cap))
    got = tscatter.tile_scatter_add(torch.from_numpy(g),
                                    torch.from_numpy(idx), f)
    assert got.shape == (f, d) and got.dtype == torch.float32
    # index_add_ sums a row's N(0, 1) terms in another order than JAX's
    # one-hot products: measured up to 2.4e-7 apart (bimodal), a few ulp
    # of the partial sums.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_scatter_drops_out_of_range_ids():
    g = torch.ones((1, 2, 4))
    idx = torch.tensor([[-1, 0, 3, 7]], dtype=torch.int32)
    got = tscatter.tile_scatter_add(g, idx, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  [[1, 1], [0, 0], [0, 0], [1, 1]])


@pytest.mark.parametrize("frame_hw", [None, (32, 64)])
def test_gather_rows_tiled_backward(frame_hw):
    """Forward ``rows[max(idx, 0)]``; backward kernel G's plain version on
    pixel squares (with ``frame_hw``) or row-major strips, plus the
    misses' cotangent credited to row 0 — equal to plain autograd."""
    rng = np.random.default_rng(3)
    n, d, f = 32 * 64, 10, 768
    idx = rng.integers(0, f, n).astype(np.int32)
    idx[rng.random(n) < 0.1] = -1
    rows = torch.from_numpy(rng.normal(size=(f, d)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    ti = torch.from_numpy(idx)

    r1 = rows.clone().requires_grad_()
    out = tscatter.gather_rows_tiled(r1, ti, (n // 256, 256),
                                     frame_hw=frame_hw)
    (out * ct).sum().backward()
    r2 = rows.clone().requires_grad_()
    ref = r2[ti.clamp(min=0).long()]
    (ref * ct).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    np.testing.assert_allclose(r1.grad.numpy(), r2.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert r1.grad[0].abs().sum() > 0


def test_retile_2d_is_pixel_squares():
    x = torch.arange(32 * 48)
    t = tscatter._retile_2d(x, (32, 48), 16)
    assert t.shape == (6, 256)
    # Tile 1 is the second 16x16 square of the first tile row.
    np.testing.assert_array_equal(t[1, :16].numpy(), np.arange(16, 32))
    np.testing.assert_array_equal(t[1, 16:32].numpy(), np.arange(64, 80))


@pytest.mark.parametrize("d, width", [(1, 1), (2, 2), (7, 1), (12, 4),
                                      (22, 2), (28, 4)])
def test_atomic_width(d, width):
    """Kernel G adds ``width`` floats per atomic: float4 where 4 divides
    the row, float2 where 2 does, else scalar; a row of ``d`` floats then
    starts on a multiple of the width."""
    assert tscatter._atomic_width(d) == width
    assert d % width == 0


def test_cuda_wrapper_rejects_cpu_tensors():
    g = torch.zeros((1, 4, 256))
    idx = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tscatter._scatter_add_cuda(g, idx, 8)
    before = tscatter.launch_counts["scatter_add"]
    tscatter.tile_scatter_add(g, idx, 8)  # CPU tensors: the plain version
    assert tscatter.launch_counts["scatter_add"] == before


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_sorted_segments_sum_equals_index_add(case):
    """G's sorted route on the CPU: the stable sort and the row bounds
    from `sorted_segments`, summed run by run in their order from 0.0 as
    `segment_sum_kernel` sums, are bitwise equal to ``index_add_``."""
    t, b, d, rows, make, *_ = SCATTER_CASES[case]
    rng = np.random.default_rng(sorted(SCATTER_CASES).index(case) + 40)
    ids = make(rng, t, b, rows)
    ids[0, :5] = rows + 3  # past the last row: dropped too
    idx = torch.from_numpy(ids.astype(np.int32))
    g = torch.from_numpy((rng.normal(size=(t, d, b))
                          * 10.0 ** rng.integers(-4, 4, (t, 1, b)))
                         .astype(np.float32))
    order, seg = tscatter.sorted_segments(idx, rows)
    assert order.dtype == torch.int32 and seg.dtype == torch.int32
    assert seg.shape == (rows + 1,) and int(seg[0]) == 0
    flat = idx.reshape(-1)
    kept = int(((flat >= 0) & (flat < rows)).sum())
    assert int(seg[-1]) == kept
    runs = torch.repeat_interleave(torch.arange(rows), seg.diff().long())
    assert torch.equal(flat[order[:kept].long()].long(), runs)
    for r in range(0, rows, max(1, rows // 97)):  # each run ascends
        run = order[seg[r]:seg[r + 1]]
        assert bool((run.diff() > 0).all())
    terms = g.transpose(1, 2).reshape(-1, d)[order[:kept].long()]
    got = torch.zeros((rows, d))
    for q in range(int(seg.diff().max())):  # the q-th term of every run
        has = seg.diff() > q
        got[has] += terms[seg[:-1][has].long() + q]
    want = tscatter._scatter_add_plain(g, idx, rows)
    assert torch.equal(got, want)


def test_sorted_route_only_under_deterministic_mode():
    """The sorted route's wrapper refuses CPU tensors; `tile_scatter_add`
    on CPU tensors runs the plain version in either mode."""
    g = torch.zeros((1, 4, 256))
    idx = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tscatter._scatter_add_sorted_cuda(g, idx, 8)
    before = dict(tscatter.launch_counts)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out = tscatter.tile_scatter_add(g + 1.0, idx, 8)
    finally:
        torch.use_deterministic_algorithms(was)
    assert tscatter.launch_counts == before
    assert torch.equal(out[0], torch.full((4,), 256.0))
